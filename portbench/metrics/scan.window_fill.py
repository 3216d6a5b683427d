"""``scan.window_fill``: of the dot pairs the energy window route's tiles
took (64 query slots a tile), the share that lay in a query's tie band,
in %: band pairs over dot pairs, from the tally the route keeps on the
card (``ops/kernels/energy_scan.window_tally``), read after the window.
The tally counts from the process's start; the warm-up sends the cell's
own traffic, so the share is the window's. Nothing to read without a
card, without the tally (a program without the window route), or where
the route took no dot pair."""


def read(ctx):
    try:
        import torch

        from matternet_rs_tpu_torch.ops.kernels.energy_scan import window_tally
    except ImportError:
        return None
    if not torch.cuda.is_available():
        return None
    t = window_tally(torch.device("cuda"))
    if not t.get("dot_pairs"):
        return None
    return 100.0 * t["band_pairs"] / t["dot_pairs"]
