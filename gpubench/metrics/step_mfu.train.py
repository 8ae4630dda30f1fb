"""Train step: the window's model FLOPs a second over the chips' dense
bf16 peak, in %. FLOPs a token are `counts.train_flops_per_token`
(no input embedding, no recompute)."""

from gpubench import counts


def read(record):
    if not record.get("tokens_per_s"):
        return None
    flops = counts.train_flops_per_token(record["arch"], record["seq"])
    return 100.0 * flops * record["tokens_per_s"] / (
        counts.PEAK_BF16_FLOPS * record["chips"])
