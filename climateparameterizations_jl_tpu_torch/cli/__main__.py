import sys

from climateparameterizations_jl_tpu_torch.cli.main import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
