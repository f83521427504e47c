"""PyTorch/CUDA port of mpe3d_tpu: multi-person 3D pose estimation on an
NVIDIA H100.

The JAX package ``mpe3d_tpu`` is the reference and is never imported here.
Library entry point: ``mpe3d_tpu_torch.pipeline.PoseEstimationPipeline``
(``infer_fused``, ``infer_stream``); serving front end:
``python -m mpe3d_tpu_torch serve`` (``cli.py``, ``serve.py``).
The TPU kernels of the serving path are hand-written CUDA kernels under
``csrc/``, built at first use by ``ops/_build.py``.
"""
