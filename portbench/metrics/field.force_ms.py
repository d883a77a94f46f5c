"""Host ms of one ``force(pos, t)`` of the run's field copy (float32 on
the card) at the cell's N, on the window's final positions and time, each
call ending in a synchronise: the median of 7 after 2 warm calls."""
MOVES = "field_step_ms"


def read(rec):
    return rec.get("force_ms")
