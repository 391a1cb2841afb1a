"""Port parity: host-side scene lowering (rayito_tpu_torch.models.scene and
the accel/ builders) against rayito_tpu's Scene.compile.

Both packages load the same procedural bumpy stand-in OBJ through their
own load_obj / stage6_scene; the reference compiles with the main path's
kernel settings (traversal='pallas', traverse_mt='bw_closest'). Every table
the traversal kernels, the winner re-test and the shading read must be
bit-identical, so global triangle ids compare directly.
"""

import numpy as np
import pytest
import torch

import rayito_tpu as rt
import rayito_tpu.models.demo as jdemo
import rayito_tpu.models.obj as jobj
import rayito_tpu.render.pallas_traverse as jpt
import rayito_tpu_torch as tt
from rayito_tpu_torch.models import demo as tdemo
from rayito_tpu_torch.models import obj as tobj
from rayito_tpu_torch.models.scene import (
    ARRAY_FIELDS,
    DOMAIN_FIELDS,
    STATIC_FIELDS,
    scene_data_from_arrays,
)

JAX_COMPILE = dict(traversal="pallas", traverse_mt="bw_closest",
                   tiny_fold=False)


@pytest.fixture(scope="module")
def standin8(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("obj") / "bumpy8.obj")
    tdemo.write_bumpy_standin(path, n=8)
    return path


def _mesh_only(pkg, objmod, path):
    s = pkg.Scene()
    s.add(objmod.load_obj(path, pkg.GlossyMaterial((0.8, 0.1, 0.1), 0.3)))
    s.add(pkg.RectangleLight((-1, 3, -1), (2, 0, 0), (0, 0, 2), (1, 1, 1),
                             2.0))
    return s


@pytest.fixture(scope="module")
def compiled(standin8):
    """{scene name: (jax SceneData, port arrays, port static)}."""
    out = {}
    for name in ("mesh_only", "stage6"):
        if name == "stage6":
            js = jdemo.stage6_scene(standin8)
            ts = tdemo.stage6_scene(standin8)
        else:
            js = _mesh_only(rt, jobj, standin8)
            ts = _mesh_only(tt, tobj, standin8)
        arrays, static = ts.compile_arrays()
        out[name] = (js.compile(**JAX_COMPILE), arrays, static)
    return out


@pytest.mark.parametrize("n,verts,faces", [(8, 386, 384),
                                           (64, 24578, 24576)])
def test_standin_topology(tmp_path, n, verts, faces):
    """The stand-in has the published topology of bumpy.obj at n=64."""
    path = str(tmp_path / "b.obj")
    tdemo.write_bumpy_standin(path, n=n)
    with open(path) as f:
        heads = [line.split(" ", 1)[0] for line in f]
    assert heads.count("v") == verts == 6 * n * n + 2
    assert heads.count("vn") == verts
    assert heads.count("f") == faces == 6 * n * n
    mesh = tobj.load_obj(path, tt.DiffuseMaterial((1, 1, 1)))
    assert mesh.indices.shape == (2 * faces, 3)
    r = np.linalg.norm(mesh.vertices, axis=1)
    assert 1.3 < r.min() and r.max() < 1.7  # radius about 1.5, bumped


def _jax_field(jsd, name):
    v = getattr(jsd, name)
    if isinstance(v, tuple):
        return [np.asarray(a) for a in v]
    return np.asarray(v)


@pytest.mark.parametrize("scene", ["mesh_only", "stage6"])
@pytest.mark.parametrize("field", [
    "ktab_tri", "ktab_mxu", "ktab_box", "ktab_base", "tri_vm_rows",
    "tri_meta_rows", "tri_vert_rows", "mat_rows", "light_shape_id",
    "light_color",
])
def test_compile_tables_bit_identical(compiled, scene, field):
    jsd, arrays, _ = compiled[scene]
    ref = _jax_field(jsd, field)
    got = arrays[field]
    if isinstance(ref, list):
        assert len(ref) == len(got) == 1
        ref, got = ref[0], got[0]
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("scene", ["mesh_only", "stage6"])
def test_compile_static_fields_match(compiled, scene):
    jsd, _, static = compiled[scene]
    for k in ("ktab_xf", "ktab_seg", "light_kinds_host",
              "light_indices_host", "traverse_mt", "traversal"):
        assert static[k] == getattr(jsd, k), k
    assert (jsd.traverse_b, jsd.traverse_sb, jsd.live_prefix,
            jsd.sort_occl) == (128, 2048, True, True)


def test_stage6_standin_kernel_layout(compiled):
    """The n=8 stand-in plus the inline box: 8 padded clusters, 128 lanes
    of boxes, BW rows beside the MT rows."""
    jsd, arrays, _ = compiled["stage6"]
    assert arrays["ktab_tri"][0].shape == (8, 16, 128)
    assert arrays["ktab_box"][0].shape == (8, 128)
    assert arrays["tri_vm_rows"].shape == (48 + 768, 32)


def test_scene_data_from_arrays_round_trip(compiled):
    """SceneData built from the reference's compiled arrays equals the
    port's own compile, tensor for tensor."""
    jsd, arrays, static = compiled["stage6"]
    ref_arrays = {k: _jax_field(jsd, k) for k in ARRAY_FIELDS + DOMAIN_FIELDS}
    # the item knobs are module defaults in the reference (env at import
    # and trace time), SceneData fields in the port
    ref_items = dict(traverse_items=False, items_w=jpt.ITEMS_W,
                     items_max=jpt.ITEMS_MAX, items_cap=jpt.ITEMS_CAP)
    ref_static = {k: ref_items[k] if k in ref_items else getattr(jsd, k)
                  for k in STATIC_FIELDS}
    from_ref = scene_data_from_arrays(ref_arrays, ref_static, "cpu")
    own = scene_data_from_arrays(arrays, static, "cpu")
    assert from_ref.device == torch.device("cpu")
    for k in ARRAY_FIELDS:
        assert torch.equal(getattr(from_ref, k), getattr(own, k)), k
    for k in DOMAIN_FIELDS:
        for a, b in zip(getattr(from_ref, k), getattr(own, k)):
            assert torch.equal(a, b), k
    for k in STATIC_FIELDS:
        assert getattr(from_ref, k) == getattr(own, k), k
    assert (own.n_planes, own.n_spheres, own.n_rects, own.n_meshes,
            own.n_lights) == (1, 5, 1, 2, 2)
