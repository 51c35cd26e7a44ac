"""repro_torch — the SPARe reproduction ported to PyTorch and CUDA on an
NVIDIA H100, beside the JAX reference package ``repro``.

The layout mirrors ``src/repro/`` module for module. The port imports
``torch`` and numpy, never ``jax`` and never ``repro``: where it needs
one of the reference's jax-free modules it keeps its own copy under the
same relative path. The slices ported so far:

* serving: ``serve`` (paged KV cache, continuous batching, SPARe-masked
  replicas) over the dense GQA and Mamba-2 families of ``models``, with
  the RMSNorm, causal GQA flash-attention and SSD-scan kernels of
  ``kernels`` (CUDA, ``sm_90a``);
* training: ``train.trainer`` and ``exec`` (Alg. 1 on the ranks of a
  ``torch.distributed`` group), ``dist`` (the §3.1 weighted sync as fp32
  buckets or the int8 error-feedback sync, with the int8 kernels of
  ``kernels``), ``optim`` (AdamW), and the backward kernels of RMSNorm
  (Triton) and flash attention (CUDA);
* the failure tiers: ``ckpt`` (disk checkpoints), ``health`` (straggler
  detection, demotion) and the scenario bridge of ``train.injection``;
* the campaign runner (``scenarios.campaign``, ``core.montecarlo``) and
  the train path's telemetry (``obs``, ``launch.obs``).

Entry points run on ``cuda`` unless the caller asks for ``cpu``.
"""
