"""The port's tools, named after their counterparts in the JAX repo's ``tools/``.

- ``parity``      (``tools/tpu_parity.py``): every CUDA kernel against the
                  NumPy oracles of ``ops.reference`` at the model's shapes.
- ``op_bench``    (``tools/op_bench.py``): FPS, ball query, 3-NN and kNN at
                  the four SA/FP shapes, each kernel beside its plain version
                  and its bound.
- ``stage_bench`` (``tools/stage_bench.py``): the SA sample-and-group, the
                  gather-only and the FP interpolate composites at
                  ``semantic.json`` widths.

Each runs on the card (``python -m pointnet2_tpu_torch.tools.<name>``) and
refuses to run without one unless given ``--device cpu``, where it runs the
plain versions (``--small`` for small shapes) and measures no time.

- ``kernel_probe`` (no counterpart): the device time of three_interpolate's
                  backward and the windowed ball queries by kernel name,
                  through the op API only, so that one copy reads an older
                  tree of the port beside a newer one; card only.
- ``bq_window_calibrate`` (``tools/bq_window_calibrate.py``, flag for flag,
                  the same table, plus ``--device``): the ball-query and
                  3-NN windows each level of sampled training batches needs.
- ``train_soak``  (``tools/train_soak.py``, flag for flag, plus ``--device``):
                  fabricated scenes, the soak configuration trained through
                  ``cli.train``, the JAX tool's summary lines.
- ``bf16_train_soak`` (``tools/bf16_train_soak.py``, plus ``--device``):
                  float32, bfloat16 and selective bfloat16 trained on one
                  pre-sampled stream; the CONVERGENCE lines.
- ``scenes``      (no counterpart): fabricated Semantic3D scenes for the
                  CLIs (``chip_smoke.py`` trains on them), and the widest
                  calibrated windows the train CLI's seeded batches need there.
"""
