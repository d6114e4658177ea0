"""Launch plumbing of the port: meshes over ``torch.distributed`` process
groups and the one-process-per-rank helper (``mesh``). Port of the mesh
half of ``src/repro/launch``; ``steps``, ``dryrun`` and ``hlo_analysis``
are ROADMAP A14's launch half."""
