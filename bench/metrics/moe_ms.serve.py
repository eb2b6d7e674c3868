"""Device milliseconds launched under the program span ``serve.moe``
(``models/moe.py::moe_ffn``, whole: the router, the dispatch, the held
experts, the combine and the shared experts) per ``serve.extend`` call,
over the traced window (``bench/spans.py``: each device operation by the
innermost program span that launched it).  Decode steps replayed from CUDA
graphs run no span; the rare eager steps' MoE layers count here too."""


def read(rec):
    dev = (rec.get("summary") or {}).get("device_by_program_span") or {}
    n = (rec.get("spans") or {}).get("serve.extend", {}).get("count")
    if not n or "serve.moe" not in dev:
        return None
    return 1e3 * dev["serve.moe"] / n
