"""The benchmark's own CPU tests (``portbench/tests/``), collected here so
that a run of ``tests/`` holds them: the loader and the contract's shape of
``BENCHMARK.json``, the readers, both references, the roofline, the
rehearsal of every cell and the planted faults (the card tests skip
without a card). Each test keeps its function and is named here
``test_<module>_<test>``; all of them sit in this one file, so a run that
spreads files over processes runs them in one process, one after another
(the stream cell's runs share one store path)."""

import importlib

MODULES = ("test_loader", "test_no_jax", "test_roofline",
           "test_generator_trace", "test_reference", "test_reference_torch",
           "test_rehearsal", "test_faults", "test_stitched", "test_card")

for _module in MODULES:
    for _name, _test in vars(importlib.import_module(
            "portbench.tests." + _module)).items():
        if _name.startswith("test_") and callable(_test):
            globals()[f"test_{_module[5:]}_{_name[5:]}"] = _test
del _module, _name, _test
