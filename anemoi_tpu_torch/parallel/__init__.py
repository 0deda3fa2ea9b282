"""Data and model parallelism on ``torch.distributed``: the port of
``anemoi_tpu.parallel`` (the mesh, the graph partition, the halo exchange
and the process wiring), one process per rank."""
