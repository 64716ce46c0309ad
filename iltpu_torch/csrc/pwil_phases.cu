// Where the time of PWIL's transport goes, phase by phase: the kernel of
// pwil_transport.cu built with PWIL_STAMPS, so thread 0 of every CTA adds
// the SM cycles (clock64) of each phase of each row to a per-CTA sum: the
// row's start (its query and a barrier), the selection pass, the CTA's
// merge, the cluster's exchange and merge, the walk, the write-back and
// refill; and counts passes and rows. A measuring tool (python -m
// iltpu_torch.profile_phases pwil); the trainer never launches it. The
// arithmetic is the real kernel's; the stamps add a clock read and a
// global add per phase on one thread.

#define PWIL_STAMPS
#include "pwil_transport.cu"
