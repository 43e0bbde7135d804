"""Graph-replay time of the banked-scoring kernel (K1) in both dtypes.

Imports ``iffnerf_tpu_torch`` from the working directory, so that two
checkouts (say a parent commit unpacked beside the change) can be timed in
turns on one card. K1 at R = 540 000 rays, D = 384, 160 of 256 patches
valid, bf16 then float32 banks from seed 0: a CUDA graph of 20 calls,
replayed 15 times, and the median per call. Prints ``<label> {dtype: ms}``.

    cd <checkout> && python3 <path>/k1_time.py <label>
"""

import statistics
import sys

import torch


def main() -> int:
    sys.path.insert(0, ".")   # the checkout in the working directory
    from iffnerf_tpu_torch.ops import banked_attention as ba

    if not torch.cuda.is_available():
        print("k1_time: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        bank = torch.randn((540000, 384), generator=g).to(dev, dt)
        q = torch.randn((256, 384), generator=g).to(dev, dt)
        valid = torch.zeros(256, dtype=torch.bool, device=dev)
        valid[40:200] = True
        for _ in range(3):
            ba.banked_scores_fused(bank, q, valid)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(20):
                ba.banked_scores_fused(bank, q, valid)
        ts = []
        for _ in range(15):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 20)
        out[str(dt).split(".")[1]] = round(statistics.median(ts), 4)
        del bank, graph
    print(sys.argv[1] if len(sys.argv) > 1 else "k1", out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
