"""The kernel build lock across processes (flexflow_tpu_torch/kernels.py):
several processes that first use one kernel at once (the ranks of a
torchrun job) build its library once, and none loads a half-written one.
There is no nvcc here, so the stub kernel's build command is a Python
one that counts its runs, takes its time and writes the library."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RACER = textwrap.dedent("""
    import sys, time
    from pathlib import Path
    from flexflow_tpu_torch import kernels

    tmp = Path(sys.argv[1])

    class Stub(kernels.CudaKernel):
        def library_path(self):
            return tmp / "libstub_0123456789ab.so"

        def build_command(self, out):
            body = ("import sys, time; "
                    f"open({str(tmp / 'runs')!r}, 'a').write('run\\\\n'); "
                    "time.sleep(1.0); "
                    "open(sys.argv[1], 'w').write('x' * 4096)")
            return [sys.executable, "-c", body, str(out)]

    stub = Stub("stub", "ragged_paged_attention.cu", "ff_stub", [], "none")
    # both processes start building at the same moment
    while not (tmp / "go").exists():
        time.sleep(0.01)
    kernels.build([stub])
    print(len(stub.library_path().read_text()))
""")


def test_two_processes_build_one_kernel_once(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _RACER, str(tmp_path)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    (tmp_path / "go").write_text("")
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        # each process saw the whole library, never a part of it
        assert out.strip() == "4096"
    assert (tmp_path / "runs").read_text() == "run\n"
    # what the build leaves beside the library: its lock, no temporary
    left = sorted(p.name for p in tmp_path.iterdir())
    assert left == ["go", "libstub_0123456789ab.lock",
                    "libstub_0123456789ab.so", "runs"]
