"""The port's entry points put their tensors on the GPU unless the CPU is
asked for: the state converters (column, parcel, box and P3 sandbox
states), the three column-step modules, the calibration, emulator
and emulator-parameter entry points, and the process group and mesh of
``parallel`` (NCCL on the card, gloo on the CPU) default to
``device="cuda"``. Where
no GPU is present that default fails with PyTorch's own error rather than
falling back to the CPU; with ``device="cpu"`` they build CPU tensors.
The 1M and 2M modules keep their parameter block on the host wherever
they step (their kernels are built for its values)."""

import inspect

import numpy as np
import pytest
import torch

import cloudmicrophysics_tpu_torch.parameters as TP
from cloudmicrophysics_tpu_torch.models import column as TC
from cloudmicrophysics_tpu_torch.models.box import BoxState
from cloudmicrophysics_tpu_torch.models.p3_sandbox import P3SandboxState
from cloudmicrophysics_tpu_torch.models.parcel import ParcelState

CONVERTERS = [
    (TP.column_state_from_numpy, TC.ColumnState),
    (TP.column_state_2m_from_numpy, TC.ColumnState2M),
    (TP.column_state_p3_from_numpy, TC.ColumnStateP3),
    (TP.parcel_state_from_numpy, ParcelState),
    (TP.box_state_from_numpy, BoxState),
    (TP.p3_sandbox_state_from_numpy, P3SandboxState),
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


def _chamber_ic():
    return ParcelState(S_l=1.0, p_air=8e4, T=251.0, q_vap=6e-4, q_liq=2e-5,
                       q_ice=0.0, N_aer=0.0, N_liq=1e8, N_ice=0.0,
                       ln_inpc=0.0)


def _calibration_and_emulator_calls():
    """The calibration, emulator and converter entry points, each called
    small with its default device; each returns a tensor of its work."""
    from cloudmicrophysics_tpu_torch.models import aida as AIDA
    from cloudmicrophysics_tpu_torch.models import calibration as CAL
    from cloudmicrophysics_tpu_torch.models import emulator as EM

    rng = np.random.default_rng(0)
    X, y = rng.normal(size=(16, 11)), rng.uniform(size=16)
    lin = dict(prior_mean=[0.0], prior_std=[1.0], y_obs=[1.0],
               noise_cov=[[1e-2]], n_iterations=2)
    abifm = dict(parcel_kwargs=dict(heterogeneous="ABIFM",
                                    condensation_growth="Condensation",
                                    const_dt=1.0, w=0.5),
                 y_obs=[0.0, 0.1], n_obs_times=2, n_iterations=1)
    t = np.arange(5.0)
    profile = AIDA.AIDAProfile(t=t, P=np.full(5, 8e4), T=251.0 - 0.01 * t,
                               e=np.full(5, 80.0), ICNC=1e5 * t)
    ap, aip, tps = (TP.aerosol.AerosolActivationParameters(),
                    TP.AirProperties(), TP.ThermodynamicsParameters())
    return {
        "eki_calibrate": (CAL.eki_calibrate, lambda **kw: CAL.eki_calibrate(
            lambda th: th, n_ensemble=4, **lin, **kw).theta),
        "uki_calibrate": (CAL.uki_calibrate, lambda **kw: CAL.uki_calibrate(
            lambda th: th, **lin, **kw).theta),
        "calibrate_abifm": (CAL.calibrate_abifm,
                            lambda **kw: CAL.calibrate_abifm(
                                _chamber_ic(), 2.0, n_ensemble=4, **abifm,
                                **kw).theta),
        "calibrate_abifm_aida": (
            AIDA.calibrate_abifm_aida,
            lambda **kw: AIDA.calibrate_abifm_aida(
                profile, 0.0, 2.0, 1e8, 1e8, 1e-6, n_obs=2, n_ensemble=4,
                n_iterations=1, **kw).theta),
        "ActivationMLP": (EM.ActivationMLP.__init__,
                          lambda **kw: EM.ActivationMLP(**kw).layers[0]
                          .weight),
        "GPRegressor": (EM.GPRegressor.__init__,
                        lambda **kw: EM.GPRegressor(**kw).fit(X, y)["alpha"]),
        "BoostedTreesRegressor": (
            EM.BoostedTreesRegressor.__init__,
            lambda **kw: EM.BoostedTreesRegressor(
                n_trees=2, depth=2, **kw).fit(X, y)["leaves"]),
        "train_emulator": (EM.train_emulator,
                           lambda **kw: EM.train_emulator(
                               X, y, n_steps=2, **kw)[1]["layers.0.bias"]),
        "train_emulator_gp": (EM.train_emulator_gp,
                              lambda **kw: EM.train_emulator_gp(
                                  X, y, **kw)[1]["alpha"]),
        "train_emulator_trees": (EM.train_emulator_trees,
                                 lambda **kw: EM.train_emulator_trees(
                                     X, y, n_trees=2, depth=2,
                                     **kw)[1]["leaves"]),
        "generate_training_data": (
            EM.generate_training_data,
            lambda **kw: torch.as_tensor(EM.generate_training_data(
                ap, aip, tps, n_samples=4, **kw)[0])),
        "generate_parcel_training_data": (
            EM.generate_parcel_training_data,
            lambda **kw: torch.as_tensor(EM.generate_parcel_training_data(
                ap, aip, tps, n_samples=4, t_end=0.4, **kw)[1])),
        "mlp_params_from_flax": (
            TP.mlp_params_from_flax,
            lambda **kw: TP.mlp_params_from_flax(
                {"Dense_0": {"kernel": np.ones((3, 2)),
                             "bias": np.zeros(2)}}, **kw)["layers.0.weight"]),
        "gp_params_from_numpy": (
            TP.gp_params_from_numpy,
            lambda **kw: TP.gp_params_from_numpy(
                {"alpha": np.ones(3)}, **kw)["alpha"]),
        "trees_params_from_numpy": (
            TP.trees_params_from_numpy,
            lambda **kw: TP.trees_params_from_numpy(
                {"features": np.zeros((2, 2))}, **kw)["features"]),
    }


ENTRY_POINTS = sorted(_calibration_and_emulator_calls())


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_calibration_and_emulators_default_to_cuda(name):
    fn, call = _calibration_and_emulator_calls()[name]
    assert _default(fn) == "cuda"
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            call()
    assert call(device="cpu").device.type == "cpu"


@pytest.fixture
def no_group(monkeypatch):
    """No launcher environment, and no process group left up after the
    test."""
    import torch.distributed as dist

    from cloudmicrophysics_tpu_torch.parallel import comms

    for name in comms._LAUNCHER_ENV + ("LOCAL_RANK",):
        monkeypatch.delenv(name, raising=False)
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_initialize_distributed_selects_nccl_unless_the_cpu(no_group):
    import torch.distributed as dist

    from cloudmicrophysics_tpu_torch.parallel import initialize_distributed

    assert _default(initialize_distributed) == "cuda"
    one = lambda **kw: initialize_distributed(
        store=dist.HashStore(), world_size=1, rank=0, **kw)
    if torch.cuda.is_available():
        one()
        assert dist.get_backend() == "nccl"
        dist.destroy_process_group()
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            one()
        assert not dist.is_initialized()
    one(device="cpu")
    assert dist.get_backend() == "gloo"


def test_column_mesh_selects_the_card_unless_the_cpu(no_group):
    import torch.distributed as dist

    from cloudmicrophysics_tpu_torch.parallel import column_mesh

    assert _default(column_mesh) == "cuda"
    if torch.cuda.is_available():
        mesh = column_mesh()
        assert mesh.device_type == "cuda" and dist.get_backend() == "nccl"
        dist.destroy_process_group()
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            column_mesh()
        assert not dist.is_initialized()
    mesh = column_mesh(device="cpu")
    assert mesh.device_type == "cpu" and dist.get_backend() == "gloo"
    assert mesh.mesh_dim_names == ("columns",) and mesh.size() == 1
