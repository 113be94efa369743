"""Distribution (port of ``src/repro/launch``): meshes, per-cell plans and
the dry run."""
