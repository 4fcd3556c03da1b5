"""build_s.fold-long: host seconds of the program's RoseTTAFold
constructions in set-up (`rosettafold_tpu_torch.models.rosettafold.build_s`;
one model a distinct configuration, 6 here)."""


def read(ctx):
    from rosettafold_tpu_torch.models import rosettafold

    return rosettafold.build_s if getattr(rosettafold, "builds", 0) else None
