"""Frames whose logits reached the host inside the window, over the
window."""


def read(v):
    return v.rec.items / v.rec.seconds
