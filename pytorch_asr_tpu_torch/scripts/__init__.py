"""The JAX package's benchmark scripts that reach a kernel, ported: each runs
with ``python -m pytorch_asr_tpu_torch.scripts.<name> [key=value ...]``."""
