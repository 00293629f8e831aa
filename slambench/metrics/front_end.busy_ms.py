"""Device busy ms (union) a localization-mode frame of the front end: the
operations of graph L1's replay that the program's census puts under
``warp`` and ``extract`` (with its ``extract.*`` steps), averaged over the
frames of kind ``localization`` (``measure/stages.py``)."""

from slambench.measure.stages import stage_ms


def read(tw):
    return stage_ms(tw, "graph.loc.L1", "localization",
                    lambda s: s in ("warp", "extract")
                    or s.startswith("extract."))
