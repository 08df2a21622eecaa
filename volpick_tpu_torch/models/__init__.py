from volpick_tpu_torch.models.eqtransformer import EQTransformer, VolEQTransformer
from volpick_tpu_torch.models.phasenet import PhaseNet
from volpick_tpu_torch.models.registry import from_pretrained, load_model
from volpick_tpu_torch.models.tpupicknet import TPUPickNet

__all__ = ["EQTransformer", "PhaseNet", "TPUPickNet", "VolEQTransformer", "from_pretrained", "load_model"]
