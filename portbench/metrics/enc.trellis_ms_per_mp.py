"""ms per megapixel of the trellis in the stage pass, each stage
synchronised (codec/stages.stage): the layer's busy time, not its
share of the pipelined window."""


def read(run):
    return run.stage_ms_per_mp(
        "trellis_tables", "trellis_hists", "trellis_ac", "trellis_dc",
        "trellis_eob")
