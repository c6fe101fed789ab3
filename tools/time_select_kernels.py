"""Times of the selection kernel of ``reductive_tpu_torch`` on one GPU.

    python3 tools/time_select_kernels.py [--against DIR] [--slices 4,8,16]

Prints the card's name and power limit, then one JSON line per shape and
checkout (CUDA-event medians of seven after a warm-up, milliseconds), over
random f32 scores made on the card:

* ``chunk_128q``: 128 rows of 524,288 (the chunk ``search`` streams 128
  queries in), k = 100; ``ivf_probe_16q``: 16 rows of 16,384 (an IVF probe
  over 16,384 lists), k = 8 (these 1 MB stay in the L2 cache: a warm read);
* ``smallest_ms``: ``search._smallest`` as the checkout routes it (the
  kernel where it has one, else ``torch.topk`` and the tie repair);
  ``plain_ms``: ``search._smallest_long``, the kernel's plain version;
  ``topk_ms``: ``torch.topk`` alone, the library's yardstick (its ties are
  its own); ``bound_ms``: one read of the scores at 3.35 TB/s;
* ``merge_ms``: one step of the streamed search, a chunk's selection merged
  with a ``(128, k)`` best-so-far: the kernel with the prior list where the
  checkout has it, else ``_smallest``, the ids offset, the concatenation and
  ``_smallest`` again; ``launches``: what that step puts on the card,
  kernels, copies and fills (by the profiler);
* with the kernel: ``kernel_ms`` (the wrapper, both passes), the device time
  of each pass by the profiler (``pass_ms``, ``merge_pass_ms``), and
  ``bit_equal`` (values and ids against ``plain_ms``'s route and, with the
  prior, against the concatenated merge).

With ``--against DIR`` (another checkout, for example the parent commit
unpacked by ``git archive``) every shape is also timed there, in the order
other, this, this, other, each in a process of its own that imports the
package of its checkout.  With ``--slices`` this checkout's kernel is also
timed at each given number of slices a row in place of the plan's.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PEAK_BYTES = 3.35e12
# (label, nq, n, k)
SHAPES = [("chunk_128q", 128, 524_288, 100), ("ivf_probe_16q", 16, 16_384, 8)]


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def time_ms(fn, reps: int = 7) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 7) -> tuple[dict[str, float], int]:
    """Device milliseconds a call of each kernel ``fn`` launches, by name,
    and the launches a call (the profiler's CUDA activity over ``reps``
    calls, after a warm-up; copies and fills counted too)."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    n = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            out[ev.name] = out.get(ev.name, 0.0) + ev.self_device_time_total / 1e3 / reps
            n += 1
    return out, n // reps


def worker(label: str, slices: list[int]) -> None:
    """Times this checkout (the package is imported from the current
    directory)."""
    sys.path.insert(0, str(Path.cwd()))
    import torch

    from reductive_tpu_torch import search

    try:
        from reductive_tpu_torch.ops import select
    except ImportError:
        select = None
    dev = torch.device("cuda")
    for name, nq, n, k in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(nq * n + k)
        scores = torch.randn((nq, n), generator=gen, device=dev)
        prior_scores = torch.randn((nq, n), generator=gen, device=dev)
        best = search._smallest(prior_scores, None, k)

        def step():
            if select is not None:
                return select.select_smallest_kernel(scores, k, prior=best, offset=n)
            d, i = search._smallest(scores, None, k)
            return search._smallest(torch.cat([best[0], d], 1), torch.cat([best[1], i + n], 1), k)

        row = {"shape": name, "checkout": label, "nq": nq, "n": n, "k": k,
               "smallest_ms": time_ms(lambda: search._smallest(scores, None, k)),
               "plain_ms": time_ms(lambda: search._smallest_long(scores, k)),
               "topk_ms": time_ms(lambda: torch.topk(scores, k, dim=1, largest=False)),
               "merge_ms": time_ms(step),
               "launches": device_ms(step)[1],
               "bound_ms": 4 * nq * n / PEAK_BYTES * 1e3}
        if select is not None:
            got = select.select_smallest_kernel(scores, k)
            want = search._smallest_long(scores, k)
            merged = step()
            cat = search._smallest(torch.cat([best[0], want[0]], 1),
                                   torch.cat([best[1], want[1] + n], 1), k)
            per = device_ms(lambda: select.select_smallest_kernel(scores, k))[0]
            row.update(
                kernel_ms=time_ms(lambda: select.select_smallest_kernel(scores, k)),
                pass_ms=sum(v for key, v in per.items() if "select_pass" in key),
                merge_pass_ms=sum(v for key, v in per.items() if "select_merge" in key),
                slices=select.select_plan(nq, n, k, select._sms(dev)).slices,
                bit_equal=all(torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                                          b.view(torch.int32) if b.is_floating_point() else b)
                              for a, b in zip((*got, *merged), (*want, *cat))))
        emit(**row)
        if select is not None:
            plan = select.select_plan
            for s in slices:
                select.select_plan = lambda *a, s=s, **kw: plan(*a, **kw)._replace(slices=s)
                try:
                    got = select.select_smallest_kernel(scores, k)
                    emit(shape=name, checkout=label, slices=s,
                         kernel_ms=time_ms(lambda: select.select_smallest_kernel(scores, k)),
                         bit_equal=torch.equal(got[1], search._smallest_long(scores, k)[1]))
                finally:
                    select.select_plan = plan
        del scores, prior_scores, best
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, help="another checkout to time in turn with this one")
    ap.add_argument("--slices", default="", help="also time these slices a row (comma-separated)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    slices = [int(s) for s in args.slices.split(",") if s]
    if args.worker:
        worker(args.worker, slices)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    me = [sys.executable, str(Path(__file__).resolve())]
    turns = [("this", ROOT)]
    if args.against:
        other = args.against.resolve()
        turns = [("other", other), ("this", ROOT), ("this", ROOT), ("other", other)]
    for label, cwd in turns:
        subprocess.run([*me, "--worker", label, *(["--slices", args.slices] if label == "this"
                                                  else [])], cwd=cwd, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
