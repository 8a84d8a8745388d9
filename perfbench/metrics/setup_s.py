"""Set-up time: process start to the opening of the measured window
(weights made, the program built, every shape the window uses warmed up
and, in a checkout's first run, the kernels compiled)."""

UNIT = "s"
LAYER = None
MOVES = None


def read(rec):
    return rec["setup_s"]
