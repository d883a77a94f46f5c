"""The sorted path's evaluations whose band was widened past the static
band to their widest window, over all its evaluations in the window (the
program's counters cuda_direct.BRANCHES['widened'], ['two_pass'] and
['single_pass']).  None where the program has no such counter, or made no
sorted evaluation."""
MOVES = "field_step_ms"


def read(rec):
    b = rec["branches"]
    total = b.get("two_pass", 0) + b.get("single_pass", 0)
    if "widened" not in b or not total:
        return None
    return b["widened"] / total
