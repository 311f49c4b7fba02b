"""mbases_per_s (end to end): the clean bases of every job in the window
over the window's seconds, in millions."""


def read(win) -> float:
    return win.bases / win.window_s / 1e6
