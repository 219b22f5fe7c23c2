"""Package setup (reference setup.py analogue).

Also builds the native CTC beam search decoder as a plain shared library
(the reference shells out to scripts/install_ctc_decoders.sh:1-6 for its
external C++ package; ours compiles in-tree, and decode/beam_search.py can
also build it lazily at first use)."""
import os
import subprocess
from setuptools import find_packages, setup
from setuptools.command.build_py import build_py


class BuildWithNative(build_py):
    def run(self):
        src = os.path.join("qasr_tpu", "native", "ctc_beam_search.cpp")
        out = os.path.join("qasr_tpu", "native", "libctc_beam.so")
        try:
            subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                            src, "-o", out, "-pthread"], check=True)
        except Exception as e:  # lazy build at import remains available
            print(f"native build skipped: {e}")
        super().run()


setup(
    name="qasr_tpu",
    version="0.1.0",
    description="TPU-native integer-only zero-shot quantized ASR (Q-ASR capabilities)",
    # qasr_tpu_torch: the PyTorch / CUDA port (needs torch; its kernels
    # build from kernels/csrc with nvcc at first use)
    packages=find_packages(include=["qasr_tpu", "qasr_tpu.*",
                                    "qasr_tpu_torch", "qasr_tpu_torch.*"]),
    package_data={"qasr_tpu.native": ["*.cpp", "*.so"],
                  "qasr_tpu": ["assets/*.json"],
                  "qasr_tpu_torch": ["assets/*.json", "assets/*.npz", "native/*.cpp"],
                  "qasr_tpu_torch.kernels": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "optax", "pyyaml", "scipy"],
    extras_require={
        "compat": ["torch"],          # .nemo / torch-pickle interop only
        "bpe": ["tokenizers"],
        "test": ["pytest", "torch"],
    },
    cmdclass={"build_py": BuildWithNative},
    entry_points={"console_scripts": [
        "qasr-synthesize=qasr_tpu.cli.synthesize:main",
        "qasr-inference=qasr_tpu.cli.inference:main",
        "qasr-train=qasr_tpu.cli.speech_to_text:main",
        "qasr-prepare-data=qasr_tpu.cli.prepare_data:main",
        "qasr-segment=qasr_tpu.cli.segment:main",
        "qasr-vad-post=qasr_tpu.cli.vad_post:main",
    ]},
)
