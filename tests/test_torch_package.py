"""Rules of the port as a package: it imports neither ``jax`` nor the JAX
reference package ``repro``, importing it builds nothing and loads no JAX,
and its kernel wrapper takes the plain version on a CPU tensor without
touching the launch count."""
import ast
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
PORT = os.path.join(REPO, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


def test_speculative_modules_are_in_the_import_check():
    """The modules of the speculative slice are among the files the JAX
    import check walks."""
    walked = {os.path.relpath(os.path.join(root, n), PORT)
              for root, _, names in os.walk(PORT) for n in names}
    assert {"serve/speculative.py", "serve/engine.py",
            "models/attention.py", "kernels/sla2_decode_paged.py"} <= walked


def test_port_and_chip_smoke_never_import_jax_or_repro():
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tools", "profile_dit_step.py"),
             os.path.join(REPO, "tools", "profile_train_step.py"),
             os.path.join(REPO, "tools", "profile_lm_step.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = [f"{os.path.relpath(f, REPO)}:{line} imports {mod}"
           for f in files for mod, line in _imported_roots(f)
           if mod in FORBIDDEN]
    assert not bad, "\n".join(bad)


def test_import_leaves_jax_unloaded_and_builds_nothing():
    code = ("import sys, repro_torch, repro_torch.serve.diffusion, "
            "repro_torch.kernels.sla2_fwd, repro_torch.kernels.sla2_bwd, "
            "repro_torch.convert, repro_torch.train.stage1, "
            "repro_torch.train, repro_torch.data, repro_torch.checkpoint, "
            "repro_torch.serve.engine, repro_torch.models.transformer, "
            "repro_torch.kernels.sla2_decode_paged, "
            "repro_torch.serve.speculative, repro_torch.models.api, "
            "repro_torch.configs.qwen3_14b; "
            "from repro_torch.kernels import build; "
            "assert not build._loaded; "
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
            "or m == 'repro' for m in sys.modules), sorted(sys.modules)")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_cpu_tensor_takes_plain_version_and_leaves_count():
    from repro_torch.kernels.sla2_fwd import (sparse_flash_fwd,
                                              sparse_flash_fwd_plain)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 64, 16, generator=g) for _ in range(3))
    idx = torch.tensor(np.tile([[0, 2], [1, 3]], (2, 1, 1)), dtype=torch.int32)
    valid = torch.ones_like(idx)
    before = sparse_flash_fwd.launches
    kw = dict(block_q=32, block_k=16, causal=False, quant_bits="int8")
    o, lse = sparse_flash_fwd(q, k, v, idx, valid, **kw)
    po, pl = sparse_flash_fwd_plain(q, k, v, idx, valid, **kw)
    assert torch.equal(o, po) and torch.equal(lse, pl)
    assert sparse_flash_fwd.launches == before
