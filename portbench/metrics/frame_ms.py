"""frame_ms: the window's seconds over the frames completed in it, in ms
(closed loop, one client): what a robot waits per frame."""


def read(run):
    served = len(run.served)
    return run.window_s / served * 1e3 if served else None
