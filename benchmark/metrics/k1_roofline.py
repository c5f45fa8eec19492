"""K1's share of its roofline: the sum of its calls' bounds
(``counts/<config>.py``: the larger of the useful FLOPs at the fp32 peak
and the bytes read once and written once at the memory's) over the device
time of K1's kernels in the traced slice."""
K1_KERNELS = ("stage_a_gemm", "segment_softmax", "chain_kernel",
              "layered_kernel")


def read(r):
    bound = r.counts.get("k1_bound_s")
    busy = sum(e - s for name, s, e in r.view.kernels
               if _base(name).startswith(K1_KERNELS))
    if not bound or busy <= 0.0:
        return None
    return 100.0 * bound / busy


def _base(name: str) -> str:
    """A kernel's name without its namespace, C++ return type, template
    arguments or parameters."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].split("<")[0]
    return name.split()[-1] if name.split() else name
