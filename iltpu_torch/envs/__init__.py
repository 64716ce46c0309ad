from iltpu_torch.envs.classic import ENVS, Pendulum, PointMass2D
from iltpu_torch.envs.vecenv import VecEnv, make_env

__all__ = ["ENVS", "Pendulum", "PointMass2D", "VecEnv", "make_env"]
