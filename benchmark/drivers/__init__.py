"""One driver per traffic kind (``train`` so far): set-up, the measured
window, the optional profiled sub-window and the check of what the window's
path produced. ``run(cell, seed, seconds, trace, device, t_start)`` returns
a :class:`benchmark.drivers.common.Outcome`."""
