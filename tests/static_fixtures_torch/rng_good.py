"""Known-good torch rng fixture: the same jobs, threaded — no rule may
fire."""
import torch


def threaded_draws(n, gen: torch.Generator):
    a = torch.rand(n, generator=gen)
    t = torch.empty(n).uniform_(-1.0, 1.0, generator=gen)
    torch.nn.init.normal_(t, generator=gen)
    return a, t, torch.randperm(n, generator=gen)


def entry_point(cfg_seed: int):
    # Seeding from config at an entry point is the contract.
    gen = torch.Generator().manual_seed(cfg_seed)
    cpu = torch.Generator(device="cpu")
    cpu.manual_seed(cfg_seed + 1)
    return gen, cpu


def meta_shapes():
    # A bare generator starts from torch's fixed default seed: not OS
    # entropy, and outside an rng-threaded function no shadow either.
    return torch.Generator()


def required_param(n, gen=None):
    if gen is None:
        raise ValueError("pass a threaded torch.Generator")
    return torch.randn(n, generator=gen)


def other_seed_methods(sampler, cfg_seed: int):
    # .seed() / .manual_seed() on objects that are no torch generator.
    sampler.seed()
    sampler.manual_seed(0)
    return sampler
