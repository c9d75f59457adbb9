"""The port's video guardrails (aux.siglip, aux.retinaface and the two
filters) against gen3c_tpu's on the CPU.

Weights come from tiny Hugging Face / torch state dicts through each
package's converter; the port's converters give the bridged JAX trees'
tensors bit for bit. SigLIP features are held at atol 1e-5 (fp32, sums in
other orders), the classes exactly. RetinaFace's loc / conf at rtol 1e-4
of their scale (fp32 convolutions through 50 layers of random weights,
seeded to stay in a detector's range). The numpy box code, the pixelation
(OpenCV's fixed-point resize in the JAX package, numpy in the port) and
the blurred clip are equal bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from gen3c_tpu.aux import guardrail as jg
from gen3c_tpu.aux import retinaface as jr
from gen3c_tpu.aux import siglip as js
from gen3c_tpu_torch import bridge
from gen3c_tpu_torch.aux import guardrail as tg
from gen3c_tpu_torch.aux import retinaface as tr
from gen3c_tpu_torch.aux import siglip as ts

torch.set_num_threads(2)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


# ------------------------------ SigLIP ------------------------------


def _tiny_siglip(seed=0, layers=2):
    from transformers import SiglipConfig, SiglipModel

    torch.manual_seed(seed)
    cfg = SiglipConfig(
        vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=layers,
                           num_attention_heads=4, image_size=28, patch_size=14,
                           hidden_act="gelu_pytorch_tanh"),
        text_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                         num_attention_heads=2, vocab_size=64, max_position_embeddings=16))
    model = SiglipModel(cfg).eval()
    with torch.no_grad():  # non-trivial norms and biases
        for n, p in model.vision_model.named_parameters():
            if p.ndim == 1:
                p.add_(0.1 * torch.randn_like(p))
    return model


def _tiny_head(dim=32, seed=1):
    torch.manual_seed(seed)
    head = torch.nn.Sequential(
        torch.nn.Linear(dim, 512), torch.nn.BatchNorm1d(512), torch.nn.ReLU(),
        torch.nn.Linear(512, 256), torch.nn.BatchNorm1d(256), torch.nn.ReLU(),
        torch.nn.Linear(256, 7)).eval()
    with torch.no_grad():
        for m in head:
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(0.5, 2.0)
                m.weight.normal_(1, 0.2)
                m.bias.normal_(0, 0.2)
    return {f"network.layers.{k}": v for k, v in head.state_dict().items()}


def _siglip_pair():
    hf = _tiny_siglip()
    vc = hf.config.vision_config
    kw = dict(hidden_size=vc.hidden_size, intermediate_size=vc.intermediate_size,
              num_hidden_layers=vc.num_hidden_layers, num_attention_heads=vc.num_attention_heads,
              image_size=vc.image_size, patch_size=vc.patch_size,
              layer_norm_eps=vc.layer_norm_eps)
    sd = hf.vision_model.state_dict()
    jcfg, tcfg = js.SiglipVisionConfig(**kw), ts.SiglipVisionConfig(**kw)
    return hf, sd, jcfg, tcfg


def test_siglip_converters_match_bridge():
    _, sd, jcfg, tcfg = _siglip_pair()
    params = js.convert_hf_siglip_vision(sd, jcfg)
    _assert_state_equal(ts.convert_hf_siglip_vision(sd, tcfg),
                        bridge.siglip_state_from_jax(_np_tree(params)))
    full = {f"vision_model.{k}": v for k, v in sd.items()}  # a full SiglipModel's names
    _assert_state_equal(ts.convert_hf_siglip_vision(full, tcfg),
                        ts.convert_hf_siglip_vision(sd, tcfg))
    head_sd = _tiny_head()
    want = bridge.safety_head_state_from_jax(_np_tree(js.convert_safety_classifier(head_sd)))
    got = ts.convert_safety_classifier(head_sd)
    for k in want:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], want[k]), k
    assert sorted(got) == sorted(want)


def test_siglip_features_and_classes_match_jax():
    hf, sd, jcfg, tcfg = _siglip_pair()
    params = js.convert_hf_siglip_vision(sd, jcfg)
    model = ts.SiglipVisionModel(tcfg, device="cpu")
    model.load_state_dict(bridge.siglip_state_from_jax(_np_tree(params)))
    head_sd = _tiny_head()
    jhead = js.convert_safety_classifier(head_sd)
    head = ts.SafetyClassifier(32, device="cpu")
    head.load_state_dict(bridge.safety_head_state_from_jax(_np_tree(jhead)))
    frames = np.random.RandomState(0).randint(0, 255, (5, 20, 24, 3), np.uint8)
    pixels = np.stack([js.preprocess_frame(f, 28) for f in frames])
    np.testing.assert_array_equal(pixels, np.stack([ts.preprocess_frame(f, 28) for f in frames]))
    want = np.asarray(js.siglip_image_features(params, jcfg, pixels))
    got = ts.siglip_image_features(model, torch.from_numpy(pixels))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    with torch.no_grad():  # and transformers' own features
        ref = hf.get_image_features(pixel_values=torch.from_numpy(pixels))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)
    feats = want / np.linalg.norm(want, axis=-1, keepdims=True)
    jlogits = np.asarray(js.safety_classifier_apply(jhead, feats))
    logits = ts.safety_classifier_apply(head, torch.from_numpy(feats))
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), jlogits.argmax(-1))


def test_siglip_takes_a_size_off_the_patch_grid():
    """so400m's 384 px are 27 patches of 14 and 6 pixels more: HF's valid
    convolution reads the first 378, the JAX package's patch reshape fails.
    A tiny tower at 31 px and patch 14 (2 x 2 patches): the port gives
    transformers' features, JAX cannot trace."""
    from transformers import SiglipVisionConfig, SiglipVisionModel

    torch.manual_seed(0)
    kw = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
              num_attention_heads=4, image_size=31, patch_size=14)
    hf = SiglipVisionModel(SiglipVisionConfig(**kw, hidden_act="gelu_pytorch_tanh")).eval()
    tcfg, jcfg = ts.SiglipVisionConfig(**kw), js.SiglipVisionConfig(**kw)
    model = ts.SiglipVisionModel(tcfg, device="cpu")
    model.load_state_dict(ts.convert_hf_siglip_vision(hf.state_dict(), tcfg))
    pixels = np.random.RandomState(0).uniform(-1, 1, (2, 3, 31, 31)).astype(np.float32)
    with torch.no_grad():
        ref = hf(pixel_values=torch.from_numpy(pixels)).pooler_output
    np.testing.assert_allclose(model(torch.from_numpy(pixels)).numpy(), ref.numpy(), rtol=0,
                               atol=1e-5)
    params = js.convert_hf_siglip_vision(hf.state_dict(), jcfg)
    with pytest.raises(TypeError):
        jax.eval_shape(lambda p, x: js.siglip_image_features(p, jcfg, x), params,
                       jax.ShapeDtypeStruct((2, 3, 31, 31), np.float32))


def _write_video_filter(root, siglip_dir, head_sd):
    filt_dir = root / "nvidia" / "Cosmos-Guardrail1" / "video_content_safety_filter"
    filt_dir.mkdir(parents=True)
    torch.save({"model": head_sd}, filt_dir / "safety_filter.pt")


@pytest.mark.parametrize("batch_size", [1, 3, 16])
def test_video_filter_from_checkpoint_matches_jax(tmp_path, batch_size):
    """Both filters from one tiny checkpoint whose head's "Safe" bias is set
    so that some of the clip's frames are safe and some not: the verdict and
    message of every suffix of the clip (the first unsafe frame moves) are
    JAX's, whatever the batch."""
    hf = _tiny_siglip(seed=2)
    siglip_dir = tmp_path / "tiny_siglip"
    hf.save_pretrained(siglip_dir)
    frames = np.random.RandomState(0).randint(0, 255, (7, 20, 24, 3), np.uint8)
    head_sd = _tiny_head(seed=4)
    probe = ts.SiglipVisionModel(ts.SiglipVisionConfig(**{
        k: getattr(hf.config.vision_config, k) for k in (
            "hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
            "image_size", "patch_size", "layer_norm_eps")}), device="cpu")
    probe.load_state_dict(ts.convert_hf_siglip_vision(hf.vision_model.state_dict(), probe.cfg))
    head = ts.SafetyClassifier(32, device="cpu")
    head.load_state_dict(ts.convert_safety_classifier(head_sd))
    feats = probe(torch.from_numpy(np.stack([ts.preprocess_frame(f, 28) for f in frames])))
    logits = head(feats / torch.linalg.norm(feats, dim=-1, keepdim=True))
    margin = (logits[:, 1:].max(-1).values - logits[:, 0]).sort().values
    head_sd["network.layers.6.bias"][0] += float(margin[3] + margin[4]) / 2  # 4 frames safe
    _write_video_filter(tmp_path, siglip_dir, head_sd)
    theirs = jg.VideoContentSafetyFilter(str(tmp_path), siglip_name=str(siglip_dir))
    ours = tg.VideoContentSafetyFilter.from_checkpoint(str(tmp_path), siglip_name=str(siglip_dir),
                                                       device="cpu")
    ours.batch_size = batch_size
    verdicts = []
    for start in range(7):  # the first unsafe frame moves with the clip's start
        want = theirs.is_safe(frames[start:])
        assert ours.is_safe(frames[start:]) == want
        verdicts.append(want)
    assert len(set(verdicts)) > 1, verdicts
    assert ours.is_safe(frames[:0]) == theirs.is_safe(frames[:0])


# ------------------------------ RetinaFace ------------------------------


@pytest.fixture(scope="module")
def retina():
    """The port's seeded detector with seeded BatchNorm statistics and head
    biases, and the same weights as a gen3c_tpu tree (its converter)."""
    net = tr.init_retinaface_params(torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, tr._BN):
                c = m.weight.shape[0]
                m.weight.copy_(0.5 + torch.rand(c, generator=gen))
                m.bias.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_mean.add_(0.1 * torch.randn(c, generator=gen))
                m.running_var.mul_(0.5 + 1.5 * torch.rand(c, generator=gen))
        for head in (*net.ClassHead, *net.BboxHead):
            head.conv1x1.bias.copy_(0.1 * torch.randn(head.conv1x1.bias.shape, generator=gen))
    return jr.convert_retinaface(net.state_dict()), net


def _torch_layout(net) -> dict:
    """The detector's weights in Resnet50_Final.pth's full layout."""
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(7)
    sd["LandmarkHead.0.conv1x1.weight"] = torch.zeros(20, 256, 1, 1)
    return sd


def test_retinaface_converter_matches_bridge(retina):
    params, net = retina
    _assert_state_equal(bridge.retinaface_state_from_jax(_np_tree(params)), net.state_dict())
    sd = _torch_layout(net)
    want = bridge.retinaface_state_from_jax(_np_tree(jr.convert_retinaface(sd)))
    for wrapped in (sd, {f"module.{k}": v for k, v in sd.items()}, {"state_dict": sd}):
        _assert_state_equal(tr.convert_retinaface(wrapped), want)
    # the JAX package's own init, carried across
    tree = _np_tree(jr.init_retinaface_params(jax.random.PRNGKey(0)))
    other = tr.RetinaFace(device="cpu")
    other.load_state_dict(bridge.retinaface_state_from_jax(tree))
    _assert_state_equal(bridge.retinaface_state_from_jax(_np_tree(
        jr.convert_retinaface(other.state_dict()))), other.state_dict())


def test_retinaface_forward_matches_jax(retina):
    params, net = retina
    x = np.random.RandomState(1).uniform(-120, 130, (2, 3, 64, 96)).astype(np.float32)
    jloc, jconf = (np.asarray(a) for a in jr.retinaface_forward(params, x))
    loc, conf = net(torch.from_numpy(x))
    assert loc.shape == (2, jr.prior_boxes(64, 96).shape[0], 4) == jloc.shape
    scale = np.abs(jloc).max()
    np.testing.assert_allclose(loc.numpy(), jloc, rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(conf.numpy(), jconf, rtol=0, atol=1e-4)


@pytest.mark.parametrize("hw", [(64, 96), (100, 37), (704, 1280)])
def test_priors_decode_nms_bit_equal(hw):
    h, w = hw
    np.testing.assert_array_equal(tr.prior_boxes(h, w), jr.prior_boxes(h, w))
    priors = tr.prior_boxes(h, w)
    rng = np.random.RandomState(h)
    loc = rng.normal(0, 30, (2, priors.shape[0], 4)).astype(np.float32)
    np.testing.assert_array_equal(tr.decode_boxes(loc, priors), jr.decode_boxes(loc, priors))
    boxes = tr.decode_boxes(loc, priors)[0] * np.array([w, h, w, h], np.float32)
    scores = rng.uniform(0, 1, priors.shape[0]).astype(np.float32)
    dets = np.hstack([boxes[:300], scores[:300, None]]).astype(np.float32)
    assert tr.nms(dets, 0.4) == jr.nms(dets, 0.4)
    for conf in (0.3, 0.7, 0.95):
        np.testing.assert_array_equal(
            tr.filter_detected_boxes(boxes, scores, confidence_threshold=conf),
            jr.filter_detected_boxes(boxes, scores, confidence_threshold=conf))


def test_pixelate_face_bit_equal():
    rng = np.random.RandomState(0)
    for h in (1, 2, 4, 5, 10, 20, 21, 33, 64, 143):
        for w in (1, 3, 5, 10, 20, 27, 64, 200):
            face = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            for blocks in (5, 3):
                np.testing.assert_array_equal(tr.pixelate_face(face, blocks),
                                              jr.pixelate_face(face, blocks), err_msg=f"{h} {w}")


def test_blur_faces_in_frames_bit_equal(retina):
    params, net = retina
    frames = np.random.RandomState(2).randint(0, 255, (4, 96, 128, 3), np.uint8)
    for bs, thr, min_size in ((4, 0.5, (20, 20)), (2, 0.55, (8, 8)), (4, 0.7, (20, 20))):
        want = jr.blur_faces_in_frames(params, frames, batch_size=bs, confidence_threshold=thr,
                                       min_size=min_size)
        got = tr.blur_faces_in_frames(net, frames, batch_size=bs, confidence_threshold=thr,
                                      min_size=min_size)
        np.testing.assert_array_equal(got, want)
        if thr < 0.7:
            assert (got != frames).any()  # boxes were pixelated


def test_retinaface_filter_from_checkpoint_matches_jax(tmp_path, retina):
    path = tmp_path / "nvidia" / "Cosmos-Guardrail1" / "face_blur_filter"
    path.mkdir(parents=True)
    torch.save({f"module.{k}": v for k, v in _torch_layout(retina[1]).items()},
               path / "Resnet50_Final.pth")
    frames = np.random.RandomState(1).randint(0, 255, (3, 64, 64, 3), np.uint8)
    for thr in (0.7, 0.5):  # none found, some found
        theirs = jg.RetinaFaceFilter(str(tmp_path), confidence_threshold=thr)
        ours = tg.RetinaFaceFilter.from_checkpoint(str(tmp_path), confidence_threshold=thr,
                                                   device="cpu")
        np.testing.assert_array_equal(ours.postprocess(frames), theirs.postprocess(frames))


def test_video_runner_from_checkpoints(tmp_path, retina):
    hf = _tiny_siglip(seed=5)
    siglip_dir = tmp_path / "google" / "siglip-so400m-patch14-384"
    hf.save_pretrained(siglip_dir)
    _write_video_filter(tmp_path, siglip_dir, _tiny_head(seed=6))
    path = tmp_path / "nvidia" / "Cosmos-Guardrail1" / "face_blur_filter"
    path.mkdir(parents=True)
    torch.save(_torch_layout(retina[1]), path / "Resnet50_Final.pth")
    filt = tg.VideoContentSafetyFilter.from_checkpoint(str(tmp_path), siglip_name=str(siglip_dir),
                                                       device="cpu")
    blur = tg.RetinaFaceFilter.from_checkpoint(str(tmp_path), device="cpu")
    runner = tg.GuardrailRunner([filt], postprocessors=[blur])
    frames = np.random.RandomState(3).randint(0, 255, (2, 64, 64, 3), np.uint8)
    safe, _ = filt.is_safe(frames)
    out = runner.run(frames)
    if safe:
        np.testing.assert_array_equal(out, blur.postprocess(frames))
    else:
        assert out is None
