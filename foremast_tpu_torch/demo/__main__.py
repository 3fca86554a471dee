"""`python -m foremast_tpu_torch.demo` — run the instrumented demo workload."""

from foremast_tpu_torch.demo.app import main

if __name__ == "__main__":
    main()
