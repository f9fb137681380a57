"""GNNAutoScale in PyTorch for one NVIDIA H100 — the port of `src/repro`.

The JAX package `repro` is the reference; this package imports nothing of
it and never imports `jax`. It mirrors the reference's layout
(`data`, `core`, `gnn`, `kernels`, `train`, `launch`) and so far covers
serving a GCN over the history cache with f32 histories:

    ServeConfig -> build_serve_plan -> init_serve_state -> serve_request

Its main path runs four CUDA kernels written for `sm_90a`
(`kernels/csrc/*.cu`): `gather_rows`, `scatter_rows`, `bcsr_spmm` and the
f32 `gather_spmm`. Entry points take `device=None`, which means "cuda";
the CPU runs only when a caller asks for it (`device="cpu"`), and then
every kernel wrapper runs its plain PyTorch version.
"""
