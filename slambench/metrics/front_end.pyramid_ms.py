"""Device busy ms (union) a localization-mode frame of the ORB pyramid:
the operations of graph L1's replay that the program's census puts under
``extract.pyramid`` (the resize products and their bf16 roundings),
averaged over the frames of kind ``localization``."""

from slambench.measure.stages import stage_ms


def read(tw):
    return stage_ms(tw, "graph.loc.L1", "localization",
                    lambda s: s == "extract.pyramid")
