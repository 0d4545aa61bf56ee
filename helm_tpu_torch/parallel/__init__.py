"""Multi-device gate sharding (`mesh.py`) and multi-process runs over
`torch.distributed` (`distributed.py`); `dryrun.py` runs the reference's
multi-device dryrun on a mesh."""
