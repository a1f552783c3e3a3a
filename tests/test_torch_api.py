"""The operator API and the utilities of the port against the JAX package on
the CPU: ``BlindSubbandFiltering.noise_coherent_init``, ``update_H`` with
``use_noise`` and with ``phases``, and ``design_filter(correct_OLA=False)``;
``print_model_summary``'s table (and the trainer with
``logging.print_model_summary``); the spectrogram's log magnitude and its
figure.  Test size: the operator of the blind config (Nf 100), TINY_NET.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_common import (BLIND_SMALL, TINY_NET, FixedLoader, clean_wav, jax_compose,
                               jax_tiny_bundle, op_hp, rel_err, to_torch, torch_compose,
                               torch_tiny_bundle)


@pytest.fixture(scope="module")
def ops():
    from buddy_tpu.operators.subband import BlindSubbandFiltering as JBlind
    from buddy_tpu_torch.operators.subband import BlindSubbandFiltering
    jop = JBlind(op_hp(jax_compose(BLIND_SMALL)), sample_rate=16000)
    top = BlindSubbandFiltering(op_hp(torch_compose(BLIND_SMALL)), sample_rate=16000,
                                device="cpu")
    return jop, top


def _jax_params(jop):
    return {k: np.asarray(v) for k, v in jop.params.items()}


def _assert_phases(ours, ref, H):
    """Phases agree (wrapped) as far as H does: an error of 1e-4 of the
    peak moves the angle of a value h by up to about 1e-4 peak / |h| (twice
    that here), checked where |h| is above 1e-3 of the peak; below, the
    angle follows the rounding."""
    d = np.angle(np.exp(1j * (np.asarray(ours, np.float64) - np.asarray(ref, np.float64))))
    mag = np.abs(H)
    big = mag > 1e-3 * mag.max()
    assert big.sum() > 1000
    assert (np.abs(d) <= 2e-4 * mag.max() / np.maximum(mag, 1e-30))[big].all()


@pytest.mark.parametrize("correct_ola", [True, False])
def test_design_filter_against_jax(ops, correct_ola):
    """design_filter of the JAX operator's initial decays and weights, with
    and without the OLA correction: 1e-6 of the peak; without it, the
    first (win / hop - 1) frames differ from the corrected ones."""
    jop, top = ops
    params = _jax_params(jop)
    ref = np.asarray(jop.design_filter({k: jnp.asarray(v) for k, v in params.items()},
                                       correct_OLA=correct_ola))
    ours = top.design_filter(to_torch(params), correct_OLA=correct_ola).numpy()
    assert ours.shape == ref.shape == (top.n_fft // 2 + 1, top.Nf)
    assert rel_err(ours, ref) < 1e-6
    other = top.design_filter(to_torch(params), correct_OLA=not correct_ola).numpy()
    k = top.win_length // top.hop_length - 1
    assert not np.allclose(other[:, :k], ours[:, :k]) and np.array_equal(other[:, k:], ours[:, k:])


def test_noise_coherent_init_and_update_H_against_jax(ops):
    """``noise_coherent_init`` and ``update_H(use_noise=True)`` with JAX's
    normal draw handed over, from the JAX operator's decays and weights: H
    within 1e-4 of its peak (the cons projection's tolerance,
    test_torch_operators.py), the stored phases those of H; then
    ``update_H(phases=)`` with JAX's phases: H within 1e-4."""
    from buddy_tpu_torch.operators.subband import BlindSubbandFiltering
    jop, _ = ops
    top = BlindSubbandFiltering(op_hp(torch_compose(BLIND_SMALL)), sample_rate=16000,
                                device="cpu")
    top.params = to_torch(_jax_params(jop))
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.normal(key, (jop.length_rir,)))

    jop.noise_coherent_init(key)
    H_ref, ph_ref = np.asarray(jop.H), np.asarray(jop.params["phases"])
    top.noise_coherent_init(torch.from_numpy(noise))
    assert rel_err(top.H.numpy(), H_ref) < 1e-4
    assert torch.equal(top.params["phases"], torch.angle(top.H))
    _assert_phases(top.params["phases"].numpy(), ph_ref, H_ref)

    key2 = jax.random.PRNGKey(6)
    jop.update_H(use_noise=True, rng=key2)
    top.update_H(use_noise=True, noise=torch.from_numpy(np.array(
        jax.random.normal(key2, (jop.length_rir,)))))
    assert rel_err(top.H.numpy(), np.asarray(jop.H)) < 1e-4

    phases = np.asarray(jax.random.uniform(jax.random.PRNGKey(7), ph_ref.shape,
                                           minval=-np.pi, maxval=np.pi))
    jop.update_H(phases=phases)
    top.update_H(phases=phases)
    assert rel_err(top.H.numpy(), np.asarray(jop.H)) < 1e-4
    np.testing.assert_array_equal(top.params["phases"].numpy(), phases)

    # a generator in place of the noise; an informed update still takes a filter
    g = torch.Generator().manual_seed(1)
    top.noise_coherent_init(torch.randn((top.length_rir,), generator=g))
    H0 = top.H.clone()
    top.update_H(use_noise=True)
    assert torch.equal(top.H, H0)
    top.update_H(H=H0 * 2)
    assert torch.equal(top.H, H0 * 2)


def test_print_model_summary_against_jax(capsys, tmp_path):
    """The table the port prints for a network's parameters is the JAX
    package's for the same weights, at max_depth 2 and 3; the
    trainer with ``logging.print_model_summary=true`` prints it instead of
    raising."""
    from buddy_tpu.utils.summary import print_model_summary as jax_summary
    from buddy_tpu_torch.config import instantiate
    from buddy_tpu_torch.utils.summary import print_model_summary
    jnet, tree = jax_tiny_bundle(4096, seed=2)
    net = torch_tiny_bundle(tree)
    for depth in (2, 3):
        n_ref = jax_summary(jax.device_get(jnet.params), max_depth=depth)
        ref = capsys.readouterr().out
        assert print_model_summary(dict(net.module.named_parameters()), max_depth=depth) \
            == n_ref == net.num_params
        assert capsys.readouterr().out == ref
    assert "unet/all_modules_0" in ref and ref.splitlines()[-1].split()[-1] == f"{n_ref:,}"

    args = torch_compose(TINY_NET + ["exp.batch_size=2", "exp.audio_len=4096",
                                     "logging.print_model_summary=true", "exp.resume=False",
                                     f"model_dir={tmp_path}"])
    batch = np.stack([clean_wav(0)[:4096], clean_wav(1)[:4096]])
    instantiate(args["exp"]["trainer"], args, FixedLoader(batch), net,
                instantiate(args["diff_params"]), None, device="cpu")
    assert capsys.readouterr().out.count("Total") == 1


def test_spectrogram_against_jax(tmp_path):
    """``log_spectrogram`` (n_fft = win_size, hop_size, constant padding,
    Hann) against the array the JAX ``plot_spectrogram_from_raw_audio``
    draws: the magnitudes within 1e-5 of their peak, the dB values within
    1e-3 where the magnitude is above 1e-2 of the peak (below, a magnitude
    error of that size moves the dB value by more); the figure is written."""
    pytest.importorskip("matplotlib")
    from buddy_tpu.utils.log import plot_spectrogram_from_raw_audio as jax_plot
    from buddy_tpu_torch.utils.log import log_spectrogram, plot_spectrogram_from_raw_audio
    x = clean_wav(2)[:16384]
    cfg = {"win_size": 512, "hop_size": 128}
    fig = jax_plot(x, cfg, fs=16000)
    ref = np.asarray(fig.axes[0].get_images()[0].get_array(), np.float64)
    ours = log_spectrogram(x, cfg, device="cpu")
    assert ours.shape == ref.shape == (257, 16384 // 128 + 1)
    mag, mag_ref = 10 ** (ours / 20), 10 ** (ref / 20)
    assert rel_err(mag, mag_ref) < 1e-5
    big = mag_ref > 1e-2 * mag_ref.max()
    assert np.abs(ours - ref)[big].max() < 1e-3
    np.testing.assert_array_equal(log_spectrogram(torch.from_numpy(x), cfg), ours)
    out = plot_spectrogram_from_raw_audio(x, cfg, fs=16000, out_path=str(tmp_path / "s.png"),
                                          device="cpu")
    assert out == str(tmp_path / "s.png") and (tmp_path / "s.png").stat().st_size > 1000
