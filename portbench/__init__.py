"""The benchmark of ``mpe3d_tpu_torch`` (README.md)."""
