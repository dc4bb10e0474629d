from perphil_tpu_torch.models.dpp.parameters import DPPParameters

__all__ = ["DPPParameters"]
