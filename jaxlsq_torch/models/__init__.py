from .layers import QuantDense, QuantEmbed
from .qconfig import QConfig, default_qconfig
from .zoo import QuantTransformerBlock, QuantTransformerLM, init_variables

__all__ = ["QConfig", "default_qconfig", "QuantDense", "QuantEmbed",
           "QuantTransformerBlock", "QuantTransformerLM", "init_variables"]
