"""RED, Random Expert Distillation: the port of `iltpu/rewards/red.py`.

A frozen random target network and a trained predictor, both MLPs whose
output is as wide as their input (state, or state and action); the reward
is exp(-sigma_1 * mean_d (pred - target)^2). sigma_1 comes from the config
or, once, from the kernel-median heuristic on one expert batch (1 / the
median of the pairwise mean squared distances between the predictions and
the targets, `ops.pairwise.squared_distance`). The predictor may carry
input and hidden dropout while it is trained; the target never does.

The state is a dict, updated in place:
  p, m, v, t: the predictor's leaves, AdamW moments and (1,) clock,
  target: the target's leaves,
  sigma_1: 0-d float32, sigma_set: 0-d bool.
"""

from typing import Dict, Optional, Tuple

import torch

from iltpu_torch.models.fcnn import MLP
from iltpu_torch.ops.pairwise import squared_distance


class REDDiscriminator:
    def __init__(
        self,
        state_size: int,
        action_size: int,
        *,
        state_only: bool = False,
        hidden_size: int = 32,
        depth: int = 1,
        activation: str = "relu",
        input_dropout: float = 0.0,
        dropout: float = 0.0,
        reward_bandwidth_scale: Optional[float] = None,
        device=None,
    ):
        self.state_only = state_only
        n = state_size if state_only else state_size + action_size
        self.predictor = MLP(n, hidden_size, depth, n, activation, input_dropout=input_dropout,
                             dropout=dropout, device=device)
        self.target = MLP(n, hidden_size, depth, n, activation, device=device)
        self.reward_bandwidth_scale = reward_bandwidth_scale

    def init(self, generator: torch.Generator) -> Dict:
        self.predictor.reset_parameters(generator)
        self.target.reset_parameters(generator)
        p = self.predictor.leaves()
        dev = p[0].device
        given = self.reward_bandwidth_scale is not None
        return {
            "p": p, "m": [torch.zeros_like(x) for x in p], "v": [torch.zeros_like(x) for x in p],
            "t": torch.zeros(1, device=dev),
            "target": self.target.leaves(),
            "sigma_1": torch.tensor(float(self.reward_bandwidth_scale) if given else 1.0, device=dev),
            "sigma_set": torch.tensor(given, device=dev),
        }

    def atoms(self, state: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        return state if self.state_only else torch.cat([state, action], -1)

    def forward(
        self, st: Dict, state, action, *, params=None, masks=None,
        generator: Optional[torch.Generator] = None, train: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(prediction, target); with `train`, the predictor's dropout runs
        with `masks` or masks drawn from `generator`."""
        x = self.atoms(state, action)
        if not train:
            masks = None
        elif masks is None and generator is not None:
            masks = self.predictor.draw_masks(x.shape[:-1], generator)
        prediction = self.predictor.apply(x, st["p"] if params is None else params, masks)
        return prediction, self.target.apply(x, st["target"])

    @torch.no_grad()
    def set_sigma(self, st: Dict, expert_state, expert_action) -> None:
        """sigma_1 <- 1 / median(pairwise distances) on one expert batch,
        unless it is already set; in place, with no host read."""
        pred, tgt = self.forward(st, expert_state, expert_action)
        sigma = 1.0 / torch.quantile(squared_distance(pred, tgt).flatten(), 0.5)
        st["sigma_1"].copy_(torch.where(st["sigma_set"], st["sigma_1"], sigma))
        st["sigma_set"].fill_(True)

    @torch.no_grad()
    def predict_reward(self, st: Dict, state, action) -> torch.Tensor:
        pred, tgt = self.forward(st, state, action)
        return torch.exp(-st["sigma_1"] * torch.mean((pred - tgt) ** 2, -1))
