"""PointNet++ building blocks for the port: BatchNorm and shared MLPs
(``layers``), the SA and FP modules (``pointnet``), the eval-time BatchNorm
fold (``fold``) and the rest of the reference's layer toolkit (``extras``)."""
