"""Benchmark files found by name: a module is imported from its path
(metric files hold dots in their names)."""
import importlib.util
import os

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))


def load(path):
    """Import the Python file ``path``."""
    name = 'portbench_plugin_' + os.path.abspath(path).replace(
        os.sep, '_').replace('.', '_')
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find(bench, folder, name):
    """``<bench>/<folder>/<name>.py``, imported."""
    path = os.path.join(bench, folder, name + '.py')
    if not os.path.exists(path):
        raise KeyError('no %s named %r (%s)' % (folder, name, path))
    return load(path)
