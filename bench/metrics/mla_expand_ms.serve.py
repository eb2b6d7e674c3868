"""Device milliseconds launched under the program span ``serve.mla_expand``
(MLA's K/V expansion from the latent and the packing of [nope ‖ rope], in
``models/mla.py``'s extend and prefill) per ``serve.extend`` call, over the
traced window (``bench/spans.py``: each device operation by the innermost
program span that launched it).  Decode steps replayed from CUDA graphs
run no span; the rare eager steps' operations count where they nest."""


def read(rec):
    dev = (rec.get("summary") or {}).get("device_by_program_span") or {}
    n = (rec.get("spans") or {}).get("serve.extend", {}).get("count")
    if not n or "serve.mla_expand" not in dev:
        return None
    return 1e3 * dev["serve.mla_expand"] / n
