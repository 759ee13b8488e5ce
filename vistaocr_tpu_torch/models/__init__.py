from .cnn import ConvStack, ConvStageSpec
from .cnnlstm import CnnLstmOcr, ModelConfig, init_parameters

__all__ = ["ConvStack", "ConvStageSpec", "CnnLstmOcr", "ModelConfig",
           "init_parameters"]
