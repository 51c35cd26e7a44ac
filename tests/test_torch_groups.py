"""``tests/_groups.py``: the one-rank group a test opens in the test
process is down after it, whatever the test did, so the next test file
in the same worker can build a group of its own (the dry run's fake
grid raises while one is up)."""
import pytest
import torch.distributed as dist

from _groups import data_group, one_rank_group  # noqa: F401
from repro_torch.launch.lint import fake_grid
from repro_torch.launch.mesh import init_data_group


def test_the_group_is_down_after_a_body_that_raises(tmp_path):
    with pytest.raises(RuntimeError, match="the body failed"):
        with one_rank_group(tmp_path) as group:
            assert dist.is_initialized()
            assert dist.get_world_size(group) == 1
            raise RuntimeError("the body failed")
    assert not dist.is_initialized()
    with fake_grid(0, 4) as world:
        assert dist.get_world_size(world) == 4
    assert not dist.is_initialized()


def test_the_group_is_down_after_a_body_that_returns(tmp_path):
    with one_rank_group(tmp_path):
        assert dist.is_initialized()
    assert not dist.is_initialized()


def test_a_group_left_up_is_taken_down_first(tmp_path):
    """A group an earlier test left up is replaced, not joined."""
    left = init_data_group("cpu", store_path=str(tmp_path / "left"))
    with one_rank_group(tmp_path) as group:
        assert group is not left and dist.get_world_size(group) == 1
    assert not dist.is_initialized()


def test_the_fixture_gives_a_one_rank_gloo_group(data_group, tmp_path):
    """Its store lives outside the test's own directory (the checkpoint
    tests list theirs)."""
    assert dist.get_world_size(data_group) == 1
    assert dist.get_backend(data_group) == "gloo"
    assert list(tmp_path.iterdir()) == []
