"""Data parallelism over torch.distributed (`mesh.py`) and its multi-process
dry run (`dryrun.py`); counterpart of `avmoe_tpu/parallel/`."""
