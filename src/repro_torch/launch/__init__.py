"""Launch plumbing of the port, the counterpart of ``src/repro/launch``:
meshes over ``torch.distributed`` process groups and the one-process-per-
rank helper (``mesh``); the (architecture × shape × mesh) cells and their
steps (``steps``); what a step costs, counted while it runs
(``cost_analysis``, the counterpart of ``hlo_analysis``); and the dry run
of every cell on abstract tensors (``dryrun``)."""
