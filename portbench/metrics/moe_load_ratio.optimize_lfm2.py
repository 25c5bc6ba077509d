"""`moe_load_ratio.optimize_lfm2`: routed rows of the busiest expert over
the mean expert's, in the expert layer where that ratio is largest, over
the whole window: each layer's device histogram (``SparseMoE.load``,
int64 adds inside the replayed graphs), zeroed as the window opens and
read after it closes. 1 is an even load; the step's time follows its
busiest experts. None where the port keeps no histogram."""


def read(r):
    loads = r.get("moe_load")
    if not loads:
        return None
    ratios = [max(rows) * len(rows) / sum(rows) for rows in loads if sum(rows)]
    return max(ratios) if ratios else None
