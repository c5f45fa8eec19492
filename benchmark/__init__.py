"""The benchmark of ``multimodn_tpu_torch`` on NVIDIA H100 cards (see
``README.md``). Nothing here imports JAX or the JAX package."""
