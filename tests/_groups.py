"""The process group of a test that opens one in the test process: up
for the test, down on the way out, whatever the outcome.

A group left up outlives its test in the worker process, and the next
test file there that builds a group of its own (``launch.lint
.fake_grid``, ``init_data_group`` with another world size) raises. The
tests that run on a one-rank gloo group take it from :func:`data_group`
(a ``MeshExecutor`` built without a group joins the default one, so the
executor's tests take it too); ``tests/test_torch_groups.py`` holds the
teardown to its word.
"""
from __future__ import annotations

import contextlib
from pathlib import Path

import pytest

from repro_torch.launch.mesh import close_data_group, init_data_group


@contextlib.contextmanager
def one_rank_group(store_dir):
    """A one-rank gloo group as the default group, its ``FileStore`` in
    ``store_dir`` (a group an earlier test left up is taken down first);
    taken down on the way out, also when the body raises."""
    close_data_group()
    group = init_data_group("cpu", store_path=str(Path(store_dir) / "store"))
    try:
        yield group
    finally:
        close_data_group()


@pytest.fixture
def data_group(tmp_path_factory):
    """:func:`one_rank_group` for a test, its store in a directory of its
    own (a test may list its ``tmp_path``): ``from _groups import
    data_group`` in a test file."""
    with one_rank_group(tmp_path_factory.mktemp("group")) as group:
        yield group
