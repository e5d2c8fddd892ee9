"""pointnet2_tpu_torch — the PyTorch/CUDA port of ``pointnet2_tpu`` for NVIDIA Hopper.

The package mirrors the JAX package's layout and imports nothing of it:

- ``config``    own copy of the ``semantic.json`` schema (``Config``).
- ``ops``       point-set operators: plain PyTorch versions (``ops.core``) and
                hand-written CUDA kernels for ``sm_90a`` (``ops.cuda``, sources
                in ``csrc/``), dispatched by the tensor's device.
- ``nn``        BatchNorm, SharedMLP, SetAbstraction, FeaturePropagation.
- ``models``    the PointNet++ SSG segmentation network, its precomputed
                geometry and its loss.
- ``convert``   flax variable trees to ``state_dict``s and back, and seeded weights.
- ``infer``     ``Predictor``: the chunked eval forward and argmax labels.
- ``train``     ``Trainer``: the train step (forward, backward, Adam or
                momentum SGD), gradient accumulation, eval step, checkpoints.
- ``utils``     the device confusion matrix.

Everything is float32; TF32 is switched off by ``Predictor`` and ``Trainer``.
"""

__version__ = "0.1.0"
