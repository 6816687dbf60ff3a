"""In-hindsight quantization core (port of ``repro.core``): quantizers,
range estimators, policy, backend dispatch and quantized matmul sites."""
