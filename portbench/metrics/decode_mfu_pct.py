"""Model FLOPs of the timed window's decode steps
(`portbench.counts.decode_token_flops` per token) over the window's
seconds, as a share (%) of the H100's dense bf16 peak, 989 TFLOP/s."""


def read(r):
    if r.get("kind") != "decode" or not r["window_s"]:
        return None
    return (100.0 * r["window_flops"] / r["window_s"]
            / r["peaks"]["bf16_flops_per_s"])
