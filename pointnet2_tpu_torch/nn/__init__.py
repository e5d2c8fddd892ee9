"""PointNet++ building blocks for the port (eval forward)."""
