"""Package build for mxnet_tpu.

``pip install .`` builds the native libraries (dependency engine,
RecordIO, image loader, C predict API) via native/Makefile and ships
them inside the wheel, mirroring the reference's single-libmxnet
packaging (``Makefile:141-160``).
"""
import os
import subprocess

from setuptools import setup, find_packages
from setuptools.command.build_py import build_py


class BuildWithNative(build_py):
    def run(self):
        src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "native")
        if os.path.exists(os.path.join(src, "Makefile")):
            try:
                subprocess.run(["make", "-C", src], check=True)
            except Exception as e:     # noqa: BLE001
                import sys
                print("warning: native build failed (%s); "
                      "pure-python fallbacks will be used" % e,
                      file=sys.stderr)
        super().run()


setup(
    name="mxnet_tpu",
    version="0.1.0",
    description="TPU-native deep learning framework with the classic "
                "mx.* API (NDArray/Symbol/Module/KVStore) on JAX/XLA/Pallas",
    packages=find_packages(include=["mxnet_tpu", "mxnet_tpu.*",
                                    "mxnet_tpu_torch", "mxnet_tpu_torch.*"]),
    # the PyTorch/CUDA port ships its kernel sources: nvcc builds them
    # into mxnet_tpu_torch/_build at first use on a CUDA machine
    package_data={"mxnet_tpu": ["lib/*.so"],
                  "mxnet_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["numpy", "jax"],
    extras_require={"test": ["pytest", "pillow"], "torch": ["torch"]},
    cmdclass={"build_py": BuildWithNative},
)
