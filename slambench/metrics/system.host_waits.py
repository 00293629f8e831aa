"""Host waits a frame: the synchronisations and blocking copies that start
inside the harness's ``frame`` spans, over the traced frames."""

from slambench.measure import trace as TR


def read(tw):
    if not tw.n:
        return None
    return TR.waits_in(tw.waits(), tw.frames, tw.n, TR.wait_sources(tw.cpu))[0]
