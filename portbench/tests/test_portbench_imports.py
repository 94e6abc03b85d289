"""Nothing under portbench imports JAX or the JAX package, compared by
whole top-level names; the reference imports nothing of the program."""
import ast
import os

import pytest

from portbench.tests import tinytree

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'chroma_tpu'}
OLD_RECORDS = ('BENCH_', 'BASELINE.json', 'chroma_tpu/')


def _sources():
    for dirpath, _, files in os.walk(tinytree.BENCH):
        if '.cache' in dirpath:
            continue
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(dirpath, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


SOURCES = sorted(_sources())


@pytest.mark.parametrize('path', SOURCES,
                         ids=lambda p: os.path.relpath(p, tinytree.BENCH))
def test_no_jax_import(path):
    tops = {m.split('.')[0] for m in _imports(path)}
    assert not tops & FORBIDDEN


@pytest.mark.parametrize('path', [p for p in SOURCES
                                  if not p.endswith(os.path.basename(
                                      __file__))],
                         ids=lambda p: os.path.relpath(p, tinytree.BENCH))
def test_no_old_records_read(path):
    """No file names the JAX package's TPU records or its sources."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            v = node.value
            assert not any(r in v for r in OLD_RECORDS), path
            assert v != 'bench.py' and not v.endswith('/bench.py'), path


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(tinytree.BENCH, 'reference')
    for f in os.listdir(ref):
        if f.endswith('.py'):
            tops = {m.split('.')[0] for m in
                    _imports(os.path.join(ref, f))}
            assert 'chroma_tpu_torch' not in tops, f


def test_top_level_name_comparison_is_whole():
    # the program's name begins with the JAX package's
    assert 'chroma_tpu_torch'.split('.')[0] not in FORBIDDEN
