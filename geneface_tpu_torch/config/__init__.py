from geneface_tpu_torch.config.config import Config, load_config, parse_overrides, save_config

__all__ = ["Config", "load_config", "parse_overrides", "save_config"]
