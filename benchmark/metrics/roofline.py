"""``<kernel>_roofline``: the least time the card could take for the work the
traced requests need (``benchmark.roofline``: counted from the requests'
inputs by the traffic driver, as ``work["<kernel>_bytes"]`` and
``work["<kernel>_ops"]``), over the device time of the port's kernels that
do it, in %.  ``KERNELS`` holds, for each kernel family, the names of its
kernels in the trace and the type its operations are counted in; a family
not in it gets a reader of its own, ``metrics/<kernel>_roofline.py``."""

from benchmark import roofline

KERNELS = {
    # csrc/adc.cu; f32 additions
    "adc": (("adc_f32_kernel", "adc_i8_kernel"), "f32"),
    # csrc/encode.cu, csrc/assign_deep.cuh; bfloat16 products
    "encode": (("encode_bf16_kernel", "encode_f32_kernel", "deep_assign_kernel"), "bf16"),
}


def read(trace, metric):
    family = metric[:-len("_roofline")]
    names, op_type = KERNELS[family]
    t = trace.kernel_seconds(lambda name: any(k in name for k in names))
    if t <= 0 or f"{family}_bytes" not in trace.work:
        return None
    least, _ = roofline.bound(trace.work[f"{family}_bytes"], trace.work[f"{family}_ops"], op_type)
    return 100.0 * least / t
