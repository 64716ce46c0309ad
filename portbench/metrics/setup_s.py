"""End to end: seconds from the start of the benchmark's process to the
window's opening (imports, kernel and stepper builds or loads, the trainer
with its ring, filling the ring to training.start, the checked updates and
the warm-up iterations)."""


def read(ctx):
    return ctx["window"]["setup_s"]
