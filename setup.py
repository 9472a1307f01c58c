"""Install glue: `pip install -e .` registers the fleetrun console script
(reference python/setup.py.in:504-506)."""
from setuptools import setup, find_packages

setup(
    name="paddle_tpu",
    version="0.1.0",
    packages=find_packages(include=["paddle_tpu", "paddle_tpu.*",
                                    "paddle_tpu_torch",
                                    "paddle_tpu_torch.*"]),
    package_data={"paddle_tpu.native": ["*.cc"],
                  "paddle_tpu_torch": ["csrc/*.cu"]},
    entry_points={
        "console_scripts": [
            "fleetrun = paddle_tpu.distributed.fleet.launch:launch",
        ],
    },
)
