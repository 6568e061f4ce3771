"""Model zoo of the port (counterpart of ``repro.models``): so far the
dense GQA/MHA decoder of ``transformer``."""
from . import transformer
from .transformer import MLAConfig, MoEConfig, TransformerConfig
