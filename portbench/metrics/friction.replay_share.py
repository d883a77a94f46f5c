"""Share of the window's friction calls whose centre term ran as a replay
of the friction's CUDA graph: the program's ``friction.step`` spans inside
its ``integrator.chunk`` spans that hold a ``friction.replay`` span, over
all such ``friction.step`` spans.

None where the program has no span store, or no such graph (its friction
module has no ``GRAPHS`` counter: it records no ``friction.replay``), or
no ``friction.step`` span in a chunk.  A run whose capture raised reads 0."""
from portbench import spans

MOVES = "field_step_ms"
STEP, REPLAY = "friction.step", "friction.replay"


def read(rec):
    try:
        from nbody_streams_tpu_torch import friction
    except ImportError:
        return None
    store = spans.store()
    if store is None or not hasattr(friction, "GRAPHS"):
        return None
    steps = [i for i, s in enumerate(store)
             if s[0] == STEP and spans._in_chunk(store, i)]
    if not steps:
        return None
    holds = set()
    for s in store:
        if s[0] != REPLAY:
            continue
        i = s[3]
        while i >= 0 and store[i][0] != STEP:
            i = store[i][3]
        holds.add(i)
    return sum(i in holds for i in steps) / len(steps)
