"""A configuration built as the program's scene, through its public scene
API only (``rayito_tpu_torch`` ``Scene``, the shape, light and material
classes, ``Transform`` and ``models/obj.py``)."""

from __future__ import annotations

import numpy as np


def build(config: dict, obj_paths: dict):
    """The ``rayito_tpu_torch.Scene`` of ``config``; ``obj_paths`` maps
    each entry of its ``meshes`` to the OBJ file written for it. A
    material named in the configuration is one object, shared by every
    shape that names it."""
    import rayito_tpu_torch as rt
    from rayito_tpu_torch.models.obj import load_obj

    makers = {"diffuse": lambda m: rt.DiffuseMaterial(m["color"]),
              "glossy": lambda m: rt.GlossyMaterial(m["color"],
                                                    m["roughness"]),
              "reflection": lambda m: rt.ReflectionMaterial(m["color"]),
              "phong": lambda m: rt.PhongMaterial(m["color"],
                                                  m["exponent"])}
    mats = {k: makers[m["kind"]](m) for k, m in config["materials"].items()}

    def xf(s):
        t = s.get("transform")
        if not t:
            return rt.Transform()
        k = len(t["times"])
        return rt.Transform(
            times=list(t["times"]),
            translations=[tuple(v) for v in t.get("translations",
                                                  [[0.0] * 3] * k)],
            scales=[tuple(v) for v in t.get("scales", [[1.0] * 3] * k)],
            rotations=[tuple(v) for v in t.get(
                "rotations", [[1.0, 0.0, 0.0, 0.0]] * k)])

    scene = rt.Scene()
    for s in config["shapes"]:
        kind = s["type"]
        if kind == "plane":
            scene.add(rt.Plane(tuple(s["position"]), tuple(s["normal"]),
                               mats[s["material"]],
                               bullseye=bool(s.get("bullseye", False)),
                               transform=xf(s)))
        elif kind == "sphere":
            scene.add(rt.Sphere(tuple(s["position"]), s["radius"],
                                mats[s["material"]], transform=xf(s)))
        elif kind == "sphere_light":
            scene.add(rt.ShapeLight(
                rt.Sphere(tuple(s["position"]), s["radius"],
                          mats[s["material"]], transform=xf(s)),
                color=tuple(s["color"]), power=s["power"]))
        elif kind == "rect_light":
            scene.add(rt.RectangleLight(
                tuple(s["corner"]), tuple(s["side1"]), tuple(s["side2"]),
                tuple(s["color"]), s["power"], transform=xf(s)))
        elif kind == "mesh":
            if "obj" in s:
                mesh = load_obj(obj_paths[s["obj"]], mats[s["material"]])
                if mesh is None:
                    raise FileNotFoundError(obj_paths[s["obj"]])
            else:
                mesh = rt.TriangleMesh(
                    vertices=np.asarray(s["vertices"], np.float32),
                    indices=np.asarray(s["indices"], np.int32),
                    material=mats[s["material"]],
                    face_ids=(np.asarray(s["face_ids"], np.int32)
                              if "face_ids" in s else None))
            mesh.transform = xf(s)
            scene.add(mesh)
        else:
            raise ValueError(f"unknown shape type {kind!r}")
    return scene
