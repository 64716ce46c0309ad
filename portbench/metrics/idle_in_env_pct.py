"""Device: the share of the profiled sub-window, in %, that the card sat idle
in gaps that began while the host was stepping the MuJoCo envs (an
`env_step` span, the gap's start mapped to the host's clock through the
sub-window's tie). Needs the port's span recorder on (`portbench/spans.py`)."""

from portbench.spans import idle_in_pct


def read(ctx):
    return idle_in_pct(ctx, "env_step")
