"""How far the sorted path's band windows outgrow its band: the widest
window of each call, in source rows, summed over the window's calls, over
the band rows those calls had (the program's counters
cuda_direct.BRANCHES['window_rows'] and ['band_rows']).  Above 1 the
calls take the single pass; None where the program has no such
counters."""
MOVES = "field_step_ms"


def read(rec):
    b = rec["branches"]
    if "window_rows" not in b or "band_rows" not in b or not b["band_rows"]:
        return None
    return b["window_rows"] / b["band_rows"]
