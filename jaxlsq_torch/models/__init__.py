from .calibrate import calibrate, enable_param_learning_all, set_static_estimate
from .layers import FakeQuantize, QuantConv, QuantDense, QuantDenseGeneral, QuantEmbed, sow_loss
from .moe import QuantMoE, load_balance_loss, route
from .norm import BatchNorm
from .qconfig import QConfig, default_qconfig
from .quantize import QuantConv2d, QuantEmbedding, QuantLinear, quantize_model
from .toggles import (disable_fake_quant, disable_fake_quant_on_act,
                      disable_observer, disable_observer_on_weights,
                      enable_fake_quant, enable_fake_quant_on_act,
                      enable_observer, enable_observer_on_weights,
                      map_quant_state)
from .zoo import (BasicBlock, InvertedResidual, QuantCNN, QuantMLP,
                  QuantMobileNetV2, QuantResNet, QuantTransformerBlock,
                  QuantTransformerLM, init_qat_variables, init_variables,
                  mobilenetv2_cifar, resnet18_cifar)

__all__ = ["QConfig", "default_qconfig", "FakeQuantize", "QuantDense", "QuantConv",
           "QuantEmbed", "QuantDenseGeneral", "sow_loss", "quantize_model", "QuantLinear",
           "QuantConv2d", "QuantEmbedding", "BatchNorm", "QuantMLP", "QuantCNN", "BasicBlock",
           "QuantResNet", "resnet18_cifar", "InvertedResidual", "QuantMobileNetV2",
           "mobilenetv2_cifar", "init_qat_variables", "QuantTransformerBlock",
           "QuantTransformerLM", "init_variables",
           "enable_fake_quant", "disable_fake_quant",
           "enable_observer", "disable_observer",
           "enable_fake_quant_on_act", "disable_fake_quant_on_act",
           "enable_observer_on_weights", "disable_observer_on_weights",
           "map_quant_state", "calibrate", "set_static_estimate",
           "enable_param_learning_all", "QuantMoE", "load_balance_loss", "route"]
