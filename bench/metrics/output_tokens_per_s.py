"""Generated tokens that reached the host inside the window, the prefills'
first tokens included, over the window."""


def read(v):
    return v.rec.items / v.rec.seconds
