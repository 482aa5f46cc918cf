"""Scale-out: many VO streams in one set of launches (``streams``), and one process per
device on ``torch.distributed`` (``mesh``, ``launch``)."""
