"""The transport family's math: schedules, paths, objectives, sources,
random fields and samplers (port of ``anemoi_tpu.models.transport``)."""
