from setuptools import setup, find_packages

setup(
    name="segalign_tpu",
    version="0.1.0",
    description="TPU-native whole-genome aligner (SegAlign capabilities)",
    packages=find_packages(exclude=["tests"]),
    package_data={"segalign_tpu.native": ["*.cpp"],
                  "segalign_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
                  "segalign_tpu_torch.native": ["*.cpp"]},
    python_requires=">=3.10",
    install_requires=["numpy", "jax"],
    entry_points={
        "console_scripts": [
            "run_segalign=segalign_tpu.cli.run_segalign:main",
            "run_segalign_repeat_masker="
            "segalign_tpu.cli.run_segalign_repeat_masker:main",
        ]
    },
)
