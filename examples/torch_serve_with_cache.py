"""End-to-end serving on the PyTorch port: batched requests through
the full stack — GenerativeCache front, continuous-batching engine over a
torch model behind (on the card unless ``--device cpu``).

Run:  PYTHONPATH=src python examples/torch_serve_with_cache.py [--arch qwen1.5-0.5b] [--device cpu]
"""
from repro_torch.launch.serve import main

if __name__ == "__main__":
    main()
