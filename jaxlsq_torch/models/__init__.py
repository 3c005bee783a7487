from .layers import FakeQuantize, QuantConv, QuantDense, QuantEmbed
from .norm import BatchNorm
from .qconfig import QConfig, default_qconfig
from .zoo import (BasicBlock, QuantMLP, QuantResNet, QuantTransformerBlock,
                  QuantTransformerLM, init_qat_variables, init_variables,
                  resnet18_cifar)

__all__ = ["QConfig", "default_qconfig", "FakeQuantize", "QuantDense", "QuantConv",
           "QuantEmbed", "BatchNorm", "QuantMLP", "BasicBlock", "QuantResNet",
           "resnet18_cifar", "init_qat_variables", "QuantTransformerBlock",
           "QuantTransformerLM", "init_variables"]
