"""chip_smoke.py and bench.py: the GPU-only entry points refuse other
platforms, and chip_smoke's phases rehearse at tiny windows on the CPU
(the same code the GPU run executes at 1080p)."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402


def _run(args, cwd=ROOT):
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize('script', ['chip_smoke.py', 'bench.py',
                                    'benchmarks.py'])
def test_entry_point_refuses_cpu(script):
    """No GPU: non-zero exit, and no result line is printed."""
    res = _run([os.path.join(ROOT, script)])
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"metric"' not in res.stdout
    assert '"rows"' not in res.stdout
    assert 'no GPU' in res.stderr


def test_chip_smoke_needs_the_repo(tmp_path):
    """Alone in a directory, the script cannot reach the program."""
    shutil.copy(os.path.join(ROOT, 'chip_smoke.py'), tmp_path)
    res = _run(['-c', 'import chip_smoke; chip_smoke.phase_transfer()'],
               cwd=tmp_path)
    assert res.returncode != 0
    assert 'canvas_tpu' in res.stderr


@pytest.mark.parametrize('name, kw', [
    ('headline', dict(size=(320, 192), batch=4, frames=12)),
    ('planar', dict(size=(256, 144), batch=4, frames=8)),
    ('transfer', dict()),
    ('export', dict(size=(256, 144), batch=4, frames=4)),
])
def test_phase_rehearsal(name, kw, capsys):
    """Each one-GPU phase passes its own comparisons at a tiny size."""
    dict(chip_smoke.PHASES)[name](**kw)
    out = capsys.readouterr().out
    assert 'FAIL' not in out
    assert out.count('ok ') >= (0 if name == 'transfer' else 2)


def test_phase_four_rehearsal(capsys):
    """The frame-parallel phase on 4 of the virtual CPU devices:
    render_sharded and iter_batches(mesh=) bit-exact vs one device."""
    import jax
    if len(jax.devices()) < 4:
        pytest.skip('needs 4 devices, found %d' % len(jax.devices()))
    chip_smoke.phase_four(size=(256, 144), batch=8, frames=20, n=4)
    out = capsys.readouterr().out
    assert out.count('bit-exact True') == 2
    assert out.count('peak_bytes_in_use') == 4


def test_compare_flags_contract_breaks():
    """A value off by one f16 ulp outside the scaler footprint fails the
    comparison; the same change inside the footprint passes."""
    import numpy as np

    want = np.full((4, 8, 8), 0.5, np.float16)
    got = want.copy()
    got.view(np.uint16)[0, 2, 2] += 1
    exact = np.ones((4, 8, 8), bool)
    with pytest.raises(AssertionError):
        chip_smoke._compare('t', got, want, 2e-3, exact_mask=exact)
    exact[:, 2, 2] = False
    chip_smoke._compare('t', got, want, 2e-3, exact_mask=exact)


@pytest.mark.gpu
def test_headline_phase_on_gpu():
    """On a GPU: the headline phase at full 1080p width, short range."""
    chip_smoke.phase_headline(batch=16, frames=32)
