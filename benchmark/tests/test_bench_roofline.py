"""The frozen byte counts: the inPALM least bytes match the hand count in
PERF.md, and the frozen kernel_bytes still match chip_smoke.py's."""
import importlib.util
import os

from benchlib import roofline
from conftest import ROOT


def test_least_bytes_hand_count_513():
    # PERF.md section 3: q and alpha 64*513^2 + 2*65*513*512 = 50,988,096
    # entries each, beta 10*64*513^2 = 168,428,160; each read and written
    # once in float32
    assert roofline.staggered_size(65, (513, 513)) == 50_988_096
    assert roofline.inpalm_least_bytes(65, (513, 513)) == \
        8 * (2 * 50_988_096 + 168_428_160) == 2_163_234_816


def test_least_bytes_below_the_step_kernels():
    # one CA iteration runs qx_step and cx_step: their bytes bound the
    # least bytes from above
    kb = roofline.kernel_bytes(65, (513, 513))
    assert roofline.inpalm_least_bytes(65, (513, 513)) < \
        kb["qx_step"] + kb["cx_step"]


def test_frozen_kernel_bytes_match_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_copy", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from dotsocp_tpu_torch.ops.geometry import Geometry

    for nt, space in ((65, (513, 513)), (33, (129, 129, 129)), (33, (1025,))):
        assert cs.kernel_bytes(Geometry(nt=nt, space=space)) == \
            roofline.kernel_bytes(nt, space)


def test_peak_is_the_sxm_h100():
    assert roofline.hbm_peak("NVIDIA H100 80GB HBM3") == 3.35e12
    assert roofline.hbm_peak("some other card") is None
