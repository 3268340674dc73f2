from .synthetic import DataCfg, SyntheticLM
