from setuptools import find_packages, setup

setup(
    name="lit_llama_ja_tpu",
    version="0.1.0",
    description=(
        "TPU-native LLaMA framework (JAX/XLA/Pallas/pjit) with the capabilities "
        "of lit-llama-ja: quantized inference (LLM.int8 / GPTQ INT4), PEFT "
        "(LoRA / Adapter v1+v2), pretraining, finetuning, evaluation, "
        "continuous-batching serving, and checkpoint conversion."
    ),
    packages=find_packages(
        include=[
            "lit_llama_ja_tpu", "lit_llama_ja_tpu.*",
            "lit_llama_ja_tpu_torch", "lit_llama_ja_tpu_torch.*",
        ]
    ),
    # the PyTorch port's CUDA sources and headers, compiled by nvcc at first use, and
    # its C++ packed reader, compiled by g++ at first use
    package_data={"lit_llama_ja_tpu_torch": ["csrc/*.cu", "csrc/*.cuh", "native/*.cpp"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
        "numpy",
        "tokenizers",
    ],
    extras_require={
        "data": ["datasets", "zstandard"],
        "convert": ["torch", "transformers"],
        "sentencepiece": ["sentencepiece"],
        # the PyTorch/CUDA port (lit_llama_ja_tpu_torch)
        "torch": ["torch", "numpy"],
    },
)
