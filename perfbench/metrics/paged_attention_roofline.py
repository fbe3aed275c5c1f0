"""``paged_attention`` (B1, ``csrc/paged_attention.cu`` on the shared bf16
window body) against its roofline over the profiled stretch: the least
time of each of its calls (operations and bytes from
``costs/paged_attention.py``, per row its offset and window, per layer its
heads and attention window) summed, over the kernel's device time in the
profile, in %."""

from perfbench.costs import paged_attention as pa


def is_b1(name: str) -> bool:
    return ("window_attention_kernel" in name and "PagedKeys" in name
            and "CausalRows" in name) or "paged_attention_kernel" in name


def read(ctx):
    p = ctx["profile"]
    kernel_s = sum(s for n, s in p["kernels"] if is_b1(n))
    if kernel_s <= 0:
        return None
    target, draft = ctx["models"]
    least = 0.0
    for r in p["rounds"]:
        calls = list(pa.round_calls(target, draft, r["pos"], r["L"]))
        for b in r["buckets"]:
            calls += list(pa.prefill_calls(target, draft, b))
        for layer, rows in calls:
            least += ctx["peaks"].least_seconds(
                *pa.call_cost(layer, rows))
    return 100.0 * least / kernel_s
