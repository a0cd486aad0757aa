"""The port's entry points put their tensors on the GPU unless the CPU is
asked for: the state converters and the three column-step modules default
to ``device="cuda"``. Where no GPU is present that default fails with
PyTorch's own error rather than falling back to the CPU; with
``device="cpu"`` they build CPU tensors. The 1M and 2M modules keep their
parameter block on the host wherever they step (their kernels are built
for its values)."""

import inspect

import numpy as np
import pytest
import torch

import cloudmicrophysics_tpu_torch.parameters as TP
from cloudmicrophysics_tpu_torch.models import column as TC

CONVERTERS = [
    (TP.column_state_from_numpy, TC.ColumnState),
    (TP.column_state_2m_from_numpy, TC.ColumnState2M),
    (TP.column_state_p3_from_numpy, TC.ColumnStateP3),
]


def _modules():
    """Each step module's constructor, and where its parameter block lives
    when it steps on the card: the 1M and 2M kernels are built with the
    block's values compiled in, so their block stays on the host; the P3
    kernel reads its block from device memory."""
    tps = TP.ThermodynamicsParameters()
    return [
        (lambda **kw: TC.Column1MStep(TP.microphysics_1m_params(), tps,
                                      TP.terminal_velocity_params(), 1.0,
                                      100.0, **kw), "cpu"),
        (lambda **kw: TC.Column2MStep(TP.microphysics_2m_params(), tps, 1.0,
                                      100.0, **kw), "cpu"),
        (lambda **kw: TC.ColumnP3Step(
            TP.microphysics_2m_params(with_ice=True, quadrature_order=4),
            tps, 1.0, 100.0, **kw), "cuda"),
    ]


def _default(fn):
    return inspect.signature(fn).parameters["device"].default


@pytest.mark.parametrize("convert,cls", CONVERTERS)
def test_state_converters_default_to_cuda(convert, cls):
    assert _default(convert) == "cuda"
    arrays = {name: np.full((2, 3), 0.5) for name in cls._fields}
    if torch.cuda.is_available():
        assert all(t.device.type == "cuda" for t in convert(arrays))
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            convert(arrays)
    st = convert(arrays, device="cpu")
    assert isinstance(st, cls)
    assert all(t.device.type == "cpu" for t in st)


@pytest.mark.parametrize("cls", [TC.Column1MStep, TC.Column2MStep,
                                 TC.ColumnP3Step])
def test_step_modules_take_cuda_as_default_device(cls):
    assert _default(cls.__init__) == "cuda"


@pytest.mark.parametrize("index", range(3))
def test_step_modules_build_their_buffer_on_the_default_device(index):
    make, on_card = _modules()[index]
    if torch.cuda.is_available():
        assert make().params.device.type == on_card
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            make()
    model = make(device="cpu")
    assert model.params.device.type == "cpu"
    assert model.params.dtype == torch.float32
    # .to(device) keeps working
    assert model.to("cpu").params.device.type == "cpu"
