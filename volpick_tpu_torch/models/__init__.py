from volpick_tpu_torch.models.eqtransformer import EQTransformer
from volpick_tpu_torch.models.registry import from_pretrained, load_model

__all__ = ["EQTransformer", "from_pretrained", "load_model"]
