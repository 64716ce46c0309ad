from iltpu_torch.sweep.bayes import GP, BayesOpt, Param, Trial, space_from_config

__all__ = ["BayesOpt", "GP", "Param", "Trial", "space_from_config"]
