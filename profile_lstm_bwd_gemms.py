"""Where the time of the BPTT's two products goes on the card, by design
and by the rows' alignment, at B=32, T=512, bf16 streams and weights, for
H in HS: the flagship's 512, F2's 1000, and 1024, whose rows are whole
128-byte lines as 512's are and 1000's (2000 and 8000 bytes) are not.

- dwh (csrc/lstm_bwd.cu lstm_dwh_tc): the library's design, and each
  design the tree names (``DWH_DESIGNS``: 128 x 128 or 128 x 256 tiles),
  over both directions and over one (half the CTAs), beside one torch.mm
  of the same operands a direction; CUDA events after a warm-up, two runs
  each. Each row has its rate in all and an SM that its grid keeps busy,
  and the L2 bytes its stages ask for.
- the gate GEMM: its device time a launch inside ``lstm_bptt_frames``
  (torch.profiler), by the library's design and each one the tree names
  (``GEMM_DESIGNS``).
- dwh in f32 (f32 streams and weights, the parity route's kernel: in
  this tree ``lstm_dwh_fma``) over both directions, beside one f32
  torch.mm a direction (TF32 off); CUDA events, two runs each.

``--root DIR`` profiles the package of another checkout (an earlier
commit unpacked with ``git archive``), so that two trees can be timed in
one run on one card; designs are named only where that tree names them.
``--kinds`` picks what is timed (default all: dwh,gates,dwh_f32).
Prints a line a case and a JSON line; needs one CUDA card:

    python3 profile_lstm_bwd_gemms.py [--root DIR] [--kinds dwh_f32]
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np

B, T = 32, 512
HS = (512, 1000, 1024)
REPS = 20


def _ms(fn) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def _gates_us(fn) -> float:
    """The device time a launch of the gate GEMM (a kernel whose name
    holds "gates_gemm") in a profiler window over one call of ``fn``; the
    window opens with small launches, a synchronise and a pause (the
    profiler drops device events near its edges)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    pad = torch.zeros(1, device="cuda")
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(64):
                pad.add_(1.0)
            torch.cuda.synchronize()
            time.sleep(0.02)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "gates_gemm" in e.name]
        if us:
            return sum(us) / len(us)
    raise RuntimeError("the profiler saw no gate GEMM launch")


def _row(kind, H, design, ms, flops, ctas, stage_bytes, stages, sms, smi):
    busy = min(ctas, sms)
    row = {"kind": kind, "H": H, "design": design, "ms": ms,
           "tflops": flops / ms / 1e9, "ctas": ctas, "waves": ctas / sms,
           "tflops_per_busy_sm": flops / ms / 1e9 / busy,
           "l2_to_sm_tb_s": ctas * stages * stage_bytes / ms / 1e9}
    print(f"{kind} H={H} {design}: {ms:.4f} ms, {row['tflops']:.1f} "
          f"TFLOP/s, {row['tflops_per_busy_sm']:.2f} an SM over {ctas} "
          f"CTAs ({row['waves']:.2f} waves), stages ask "
          f"{row['l2_to_sm_tb_s']:.2f} TB/s of L2 ({smi})", flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="profile the package of this checkout")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--kinds", default="dwh,gates,dwh_f32",
                    help="comma-separated: dwh, gates, dwh_f32")
    args = ap.parse_args()
    kinds = set(args.kinds.split(","))
    if args.root:
        sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        print("profile_lstm_bwd_gemms: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from vistaocr_tpu_torch.ops import lstm_cuda as L

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    bf16 = torch.bfloat16
    tree = args.root or "."
    dwh_designs = (None, *getattr(L, "DWH_DESIGNS", ()))
    gemm_designs = (None, *getattr(L, "GEMM_DESIGNS", ()))

    def t_(shape, scale):
        return torch.from_numpy(rng.normal(0, scale, shape).astype(
            np.float32)).to(dev, bf16)

    out = []
    for H in HS:
        G = 4 * H
        R = (T - 1) * B
        bdirs = [(t_((T, B, G), 1.0), t_((H, G), H ** -0.5),
                  t_((T, B, H), 0.5), t_((T, B, H), 1.0), t_((T, B, H), 1.0),
                  r) for r in (False, True)]
        mask = torch.ones(T, 1, B, device=dev)
        ddirs = [(ys, t_((T, B, G), 0.1), r) for _, _, ys, _, _, r in bdirs]
        pairs = [((ys[1:] if r else ys[:-1]).reshape(-1, H),
                  (g[:-1] if r else g[1:]).reshape(-1, G))
                 for ys, g, r in ddirs]
        flops = 2 * 2 * R * H * G
        with torch.no_grad():
            mm = []
            for design in (dwh_designs if "dwh" in kinds else ()):
                name = design or "library"
                kw = {} if design is None else {"design": design}
                if design is None:
                    wide = (hasattr(L, "DWH_DESIGNS") and H > 512)
                else:
                    wide = design == "wide"
                tn = 256 if wide else 128
                ctas = -(-H // 128) * -(-G // tn)
                for nd in (2, 1):
                    mm.append(_ms(lambda: [torch.mm(
                        a.T, c, out_dtype=torch.float32)
                        for a, c in pairs[:nd]]) * 2 / nd)
                    ms = sum(_ms(lambda: L.lstm_dwh(ddirs[:nd], bf16, **kw))
                             for _ in range(2)) / 2
                    out.append(_row("dwh" if nd == 2 else "dwh_one_dir", H,
                                    name, ms, flops * nd // 2, ctas * nd,
                                    (2 + tn // 64) * 8192, -(-R // 64), sms,
                                    smi))
            if mm:
                out.append({"kind": "dwh", "H": H, "design": "torch.mm",
                            "ms": sum(mm) / len(mm)})
                print(f"dwh H={H} torch.mm: {out[-1]['ms']:.4f} ms ({smi})",
                      flush=True)
            if "dwh_f32" in kinds:
                f32d = [(ys.float(), g.float(), r) for ys, g, r in ddirs]
                p32 = [(a.float(), c.float()) for a, c in pairs]
                mm32 = _ms(lambda: [torch.mm(a.T, c) for a, c in p32])
                ms = sum(_ms(lambda: L.lstm_dwh(f32d, torch.float32))
                         for _ in range(2)) / 2
                out.append({"kind": "dwh_f32", "H": H, "design": "library",
                            "ms": ms, "tflops": flops / ms / 1e9,
                            "torch_mm_ms": mm32,
                            "bound_ms": flops / 67e12 * 1e3})
                print(f"dwh_f32 H={H}: {ms:.4f} ms ({flops / ms / 1e9:.1f} "
                      f"TFLOP/s), torch.mm {mm32:.4f} ms, bound "
                      f"{out[-1]['bound_ms']:.4f} ms ({smi})", flush=True)
            for design in (gemm_designs if "gates" in kinds else ()):
                kw = {} if design is None else {"gemm": design}
                us = _gates_us(lambda: L.lstm_bptt_frames(bdirs, mask, bf16,
                                                          **kw))
                out.append({"kind": "gates", "H": H,
                            "design": design or "library", "ms": us / 1e3,
                            "source": "profiler, device time a launch"})
                print(f"gates H={H} {design or 'library'}: {us / 1e3:.4f} "
                      f"ms a launch ({smi})", flush=True)
    line = json.dumps({"bwd_gemm_profile": out, "tree": tree, "card": smi})
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
