from evoke_tpu_torch.core.config import DecodeConfig, ModelConfig
from evoke_tpu_torch.core.device import resolve_device
