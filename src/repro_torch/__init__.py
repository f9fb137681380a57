"""GNNAutoScale in PyTorch for one NVIDIA H100 — the port of `src/repro`.

The JAX package `repro` is the reference; this package imports nothing of
it and never imports `jax`. It mirrors the reference's layout
(`data`, `core`, `gnn`, `kernels`, `train`, `launch`, `configs`,
`models`, and `examples`) and so far covers GAS training (the paper's
Algorithm 1) of the six operators, with its trainers and baselines and
the async history pipeline, training across evolving graph snapshots,
and serving them over the history cache (in process or split), over
f32, bf16, int8 and vq history tables; and serving the transformer
substrate's dense configs (prefill, then KV-cache decode):

    GASConfig -> build_plan -> init_state -> train_step / train_epoch
        -> predict / evaluate_exact
    DynamicGASConfig -> build_dynamic_plan -> advance (or fit_dynamic)
    ServeConfig -> build_serve_plan -> init_serve_state -> serve_request
    configs.base.get_config -> models.transformer.init_params -> prefill
        -> decode_step

Its kernels are written in CUDA for `sm_90a` (`kernels/csrc/*.cu`).
Entry points take `device=None`, which means "cuda"; the CPU runs only
when a caller asks for it (`device="cpu"`), and then every kernel
wrapper runs its plain PyTorch version.
"""
