"""The shared-memory opt-in of ``csrc/smem_optin.cuh`` as a host driver
reports it (``torch_march2_host optin``, ``torch_march3_host optin``):
the stand-in ``tests/torch_cuda_host.h`` records each
``cudaFuncSetAttribute`` with the current device."""

import subprocess

MAX_DYNAMIC_SMEM = 8  # cudaFuncAttributeMaxDynamicSharedMemorySize
CAPTURE_UNSUPPORTED = 900  # cudaErrorStreamCaptureUnsupported


def optin_report(exe):
    """``(rcs, nbytes, sets)`` from the driver: each call's ``(device,
    instantiation, error)``, each instantiation's block bytes, each
    recorded ``(device, instantiation, attribute, value)``."""
    out = subprocess.run([str(exe), "optin"], check=True, timeout=60,
                         capture_output=True, text=True).stdout
    rcs, nbytes, sets = [], {}, []
    for line in out.splitlines():
        kind, *vals = line.split()
        vals = [int(v) for v in vals]
        if kind == "rc":
            rcs.append(tuple(vals))
        elif kind == "bytes":
            nbytes[vals[0]] = vals[1]
        else:
            sets.append(tuple(vals))
    return rcs, nbytes, sets


def check_once_per_device(exe, insts):
    """Every launch succeeds outside a capture; each instantiation of
    ``insts`` opts in once on device 0, once on 1 (none on the repeat
    calls), not at all under a capture (device 0 opted in already: no
    call; device 2 not yet: the capture error), then once on device 2."""
    rcs, nbytes, sets = optin_report(exe)
    assert all(code == 0 for _, _, code in rcs[:-2])
    assert rcs[-2] == (2, insts[-1], CAPTURE_UNSUPPORTED)
    assert rcs[-1] == (2, insts[-1], 0)
    want = [(dev, i, MAX_DYNAMIC_SMEM, nbytes[i])
            for dev in (0, 1) for i in insts]
    want.append((2, insts[-1], MAX_DYNAMIC_SMEM, nbytes[insts[-1]]))
    assert sets == want
    assert all(n > 48 * 1024 for n in nbytes.values())
