"""Sampler taxonomy: random / stratified / correlated multi-jittered
(counterpart of ``rayito_tpu/ops/samplers.py``). All are pure functions of
(index, pattern size, permutation) returning float32 in [0, 1)."""

from __future__ import annotations

import torch

from . import rng as rngo


def random_sample_1d(index, n, permutation):
    """Unstratified: hash of (index, permutation)."""
    return rngo.cmj_rand_float(rngo.u32(index), permutation)


def random_sample_2d(index, nx, ny, permutation):
    i = rngo.u32(index)
    p = rngo.u32(permutation)
    return (
        rngo.cmj_rand_float(i, rngo._mul32(p, 0xA399D265)),
        rngo.cmj_rand_float(i, rngo._mul32(p, 0x711AD6A5)),
    )


def stratified_sample_1d(index, n, permutation):
    """(index + jitter) / n over a 1-D grid."""
    i = rngo.u32(index)
    jitter = rngo.cmj_rand_float(i, rngo.u32(permutation))
    return (i.to(torch.float32) + jitter) / float(n)


def stratified_sample_2d(index, nx, ny, permutation):
    """((ix + jx) / nx, (iy + jy) / ny) over an nx x ny grid, row-major."""
    i = rngo.u32(index)
    p = rngo.u32(permutation)
    ix = (i % nx).to(torch.float32)
    iy = (i // nx).to(torch.float32)
    jx = rngo.cmj_rand_float(i, rngo._mul32(p, 0xA399D265))
    jy = rngo.cmj_rand_float(i, rngo._mul32(p, 0x711AD6A5))
    return (ix + jx) / float(nx), (iy + jy) / float(ny)


def cmj_sample_1d(index, n, permutation):
    return rngo.cmj_sample_1d(rngo.u32(index), n, permutation)


def cmj_sample_2d(index, nx, ny, permutation):
    return rngo.cmj_sample_2d(rngo.u32(index), nx, ny, permutation)


SAMPLERS_1D = {
    "random": random_sample_1d,
    "stratified": stratified_sample_1d,
    "cmj": cmj_sample_1d,
}
SAMPLERS_2D = {
    "random": random_sample_2d,
    "stratified": stratified_sample_2d,
    "cmj": cmj_sample_2d,
}


def sample_1d(kind, index, n, permutation):
    return SAMPLERS_1D[kind](index, n, permutation)


def sample_2d(kind, index, nx, ny, permutation):
    return SAMPLERS_2D[kind](index, nx, ny, permutation)
