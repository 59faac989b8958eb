"""Known-bad torch rng fixture: each marked line fires its rule."""
import torch
from torch import randn


def global_draws(n):
    a = torch.rand(n)                                   # RNG002
    b = randn(n, generator=None)                        # RNG002
    c = torch.randint(0, 9, (n,))                       # RNG002
    d = torch.randperm(n)                               # RNG002
    e = torch.normal(0.0, 1.0, size=(n,))               # RNG002
    f = torch.bernoulli(a)                              # RNG002
    g = torch.multinomial(a, 1)                         # RNG002
    h = torch.rand_like(a)                              # RNG002
    i = torch.randn_like(b)                             # RNG002
    j = torch.randint_like(c, 9)                        # RNG002
    return a, b, c, d, e, f, g, h, i, j


def global_seeding(seed):
    torch.manual_seed(seed)                             # RNG002
    torch.seed()                                        # RNG002
    torch.cuda.manual_seed(seed)                        # RNG002
    torch.cuda.manual_seed_all(seed)                    # RNG002


def inplace_draws(t):
    t.uniform_(-1.0, 1.0)                               # RNG002
    t.normal_()                                         # RNG002
    t.random_(0, 10)                                    # RNG002
    t.exponential_()                                    # RNG002
    t.bernoulli_(0.5)                                   # RNG002
    t.geometric_(0.5)                                   # RNG002
    t.cauchy_()                                         # RNG002
    t.log_normal_()                                     # RNG002
    torch.nn.init.normal_(t)                            # RNG002
    return t


def entropy_seeded():
    g = torch.Generator()       # torch's fixed default seed: not RNG003
    g.seed()                                            # RNG003
    h = torch.Generator(device="cpu").manual_seed(7)
    h.seed()                                            # RNG003
    torch.default_generator.seed()                      # RNG003
    return g, h


def chained_shadow(n, gen=None):
    if gen is None:
        gen = torch.Generator().manual_seed(0)          # RNG004
    return torch.rand(n, generator=gen)


def split_shadow(n, gen=None):
    if gen is None:
        gen = torch.Generator(device="cpu")
        gen.manual_seed(1234)                           # RNG004
    return torch.randn(n, generator=gen)


def bare_shadow(n, generator=None):
    gen = generator or torch.Generator()                # RNG004
    return torch.randint(0, n, (n,), generator=gen)
