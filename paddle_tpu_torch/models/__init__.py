from .bert import (BertConfig, BertForMaskedLM,  # noqa: F401
                   BertForSequenceClassification, BertModel, bert_base,
                   bert_large, bert_tiny)
from .ernie import (ErnieConfig, ErnieForPretraining,  # noqa: F401
                    ErnieModel, build_ernie_pipeline, ernie_3_0_medium,
                    ernie_base, ernie_tiny)
from .llama import (LlamaConfig, LlamaForCausalLM, llama_1b,  # noqa: F401
                    llama_350m, llama_7b, llama_tiny)
from .unet import (UNet2DConditionModel, UNetConfig, unet_sd15,  # noqa: F401
                   unet_tiny)
