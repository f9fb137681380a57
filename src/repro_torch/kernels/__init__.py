"""The port's kernels: CUDA C++ for sm_90a in `csrc/`, their Python
wrappers (`gather`, `scatter`, `bcsr_spmm`, `fused`, `edge_softmax`,
`pna_reduce`, `decode_attn`), their plain
PyTorch versions (`ref`) and the dispatched ops (`ops`)."""
