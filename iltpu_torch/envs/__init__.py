from iltpu_torch.envs.classic import ENVS, Pendulum, PointMass2D
from iltpu_torch.envs.scores import SPECS, EnvSpec, d4rl_normalized_score
from iltpu_torch.envs.vecenv import BACKENDS, HostEnv, VecEnv, make_env

__all__ = ["BACKENDS", "ENVS", "EnvSpec", "HostEnv", "Pendulum", "PointMass2D", "SPECS",
           "VecEnv", "d4rl_normalized_score", "make_env"]
