from repro_torch.configs.base import ModelConfig, ServeConfig  # noqa: F401
from repro_torch.configs.registry import REGISTRY, get_config  # noqa: F401
