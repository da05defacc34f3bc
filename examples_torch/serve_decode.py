"""Fleet-backed serving with the port (the counterpart of
``examples/serve_decode.py``): requests stream into a
``TorchCleaveRuntime.serve_session`` -- a paged KV cache on the parameter
server (the card), continuous batching over fixed decode slots, and every
projection GEMM (q/k/v/out, SwiGLU, lm_head) coalesced across the batch and
executed on the edge fleet through the band GEMM kernel, with a device
failure injected (and recovered) mid-decode.  Prefills run the
flash-attention kernel, every decode step's attention the flash-decode
kernel.

Run (CUDA card):  PYTHONPATH=src python examples_torch/serve_decode.py
Run (CPU):        PYTHONPATH=src python examples_torch/serve_decode.py --device cpu
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.api import Fleet, TorchCleaveRuntime
from repro_torch.configs.base import get_config


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the PS, its cache and the kernels live "
                         "(cpu: the kernels' plain versions)")
    ap.add_argument("--dtype-policy", choices=("f32", "bf16"), default=None,
                    help="the fleet GEMMs' policy (default: the device's, "
                         "bf16 on the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rt = TorchCleaveRuntime(arch=get_config("llama3-8b").reduced(),
                            fleet=Fleet.sample(8, seed=0),
                            accounting="broadcast", device=dev)
    sess = rt.serve_session(slots=4, page_size=4, max_len=24, seed=0,
                            dtype_policy=args.dtype_policy)

    # six requests with staggered arrivals: continuous batching admits each
    # one as soon as a slot and its page budget free up
    rng = np.random.default_rng(1)
    for i in range(6):
        prompt = rng.integers(0, rt.cfg.vocab_size, size=8).astype(np.int32)
        sess.submit(prompt, max_new=6, arrival=0.5 * i)

    # decode until drained; device 3 fails during the 2nd step's in-flight
    # GEMM (churn.recover keeps the output exact: no request's KV is
    # corrupted)
    report = sess.run(fail_ids=[3], fail_at_step=2)

    print(report.log_line())
    print(f"pages: {report.cache.n_used}/{report.cache.n_pages} in use at "
          f"end, peak {report.cache.peak_pages_used}")
    for r in sess.batcher.finished[:3]:
        print(f"  req{r.rid}: arrived {r.arrival:.2f}s -> finished "
              f"{r.finish_time:.2f}s (priced), tokens {r.tokens}")
    return {"report": report, "steps": sess.step_reports,
            "finished": sess.batcher.finished, "session": sess}


if __name__ == "__main__":
    main()
