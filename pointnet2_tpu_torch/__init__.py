"""pointnet2_tpu_torch — the PyTorch/CUDA port of ``pointnet2_tpu`` for NVIDIA Hopper.

The package mirrors the JAX package's layout and imports nothing of it:

- ``config``    own copy of the ``semantic.json`` schema (``Config``).
- ``ops``       point-set operators: plain PyTorch versions (``ops.core``) and
                hand-written CUDA kernels for ``sm_90a`` (``ops.cuda``, sources
                in ``csrc/``), dispatched by the tensor's device; the NumPy
                oracles (``ops.reference``).
- ``nn``        BatchNorm, SharedMLP, SetAbstraction, FeaturePropagation.
- ``models``    the PointNet++ SSG segmentation network, its precomputed
                geometry and its loss.
- ``convert``   flax variable trees to ``state_dict``s and back, and seeded weights.
- ``infer``     ``Predictor``: the chunked eval forward and argmax labels.
- ``train``     ``Trainer``: the train step (forward, backward, Adam or
                momentum SGD), gradient accumulation, eval step, checkpoints.
- ``data``      Semantic3D file I/O, sampling, augmentation and voxels (own
                copies of the JAX package's NumPy modules), and the host
                pipeline: sampler threads and the pinned prefetch to the card.
- ``cli``       the train and predict entry points
                (``python -m pointnet2_tpu_torch.cli.train`` / ``.predict``).
- ``parallel``  runs over processes (one a device, ``torch.distributed``)
                and the point-sharded kNN and densify over devices.
- ``utils``     the device and host confusion matrices; the run logger; the
                CUDA-event timer and the bound of a kernel's work (``utils.bench``).
- ``tools``     the parity sweep against the NumPy oracles, the op bench and
                the stage bench (``python -m pointnet2_tpu_torch.tools.<name>``).

Everything is float32; TF32 is switched off by ``Predictor`` and ``Trainer``.
"""

__version__ = "0.1.0"
