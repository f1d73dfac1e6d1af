from spcies_tpu_torch.diagnostics.timing import PhaseTimer

__all__ = ["PhaseTimer"]
