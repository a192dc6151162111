/* MLX Audio TPU Studio — buildless SPA.
 *
 * Feature parity with the reference Next.js studio
 * (reference ui/app/{text-to-speech,speech-to-text,audio-separation}/page.tsx,
 * components/{audio-orb,voice-selection,theme-toggle}.tsx):
 *   - TTS: model/voice/speed/temperature -> POST /v1/audio/speech, playback,
 *     download, client-side history, WebAudio-driven orb visualizer.
 *   - STT: file upload -> POST /v1/audio/transcriptions (json), segments table.
 *   - Realtime: mic -> 16 kHz PCM16 frames over
 *     WS /v1/audio/transcriptions/realtime.
 *   - Separation: file + description -> POST /v1/audio/separations,
 *     base64 target/residual WAV playback.
 */

const $ = (id) => document.getElementById(id);
const API = ""; // same-origin

// ----------------------------------------------------------------- theme

const themeToggle = $("theme-toggle");
function setTheme(t) {
  document.documentElement.dataset.theme = t;
  localStorage.setItem("mlx-audio-theme", t);
}
setTheme(localStorage.getItem("mlx-audio-theme") || "dark");
themeToggle.addEventListener("click", () =>
  setTheme(document.documentElement.dataset.theme === "dark" ? "light" : "dark"));

// ---------------------------------------------------------------- router

const pages = ["tts", "stt", "realtime", "separation", "voices", "models"];
function route() {
  const page = (location.hash.replace("#/", "") || "tts");
  for (const p of pages) {
    $(`page-${p}`).hidden = p !== page;
    document.querySelector(`.nav-link[data-page="${p}"]`)
      .classList.toggle("active", p === page);
  }
}
window.addEventListener("hashchange", route);
route();

// ---------------------------------------------------------------- health

async function pollHealth() {
  const el = $("health");
  try {
    const r = await fetch(`${API}/health`);
    el.className = r.ok ? "health ok" : "health err";
    el.title = r.ok ? "server healthy" : "server error";
  } catch {
    el.className = "health err";
    el.title = "server unreachable";
  }
}
pollHealth();
setInterval(pollHealth, 10000);

// ------------------------------------------------------------------- orb

const orb = $("orb");
const orbCtx = orb.getContext("2d");
let analyser = null;
let orbLevel = 0;

function drawOrb() {
  requestAnimationFrame(drawOrb);
  const { width: w, height: h } = orb;
  orbCtx.clearRect(0, 0, w, h);
  let level = 0.12;
  if (analyser) {
    const data = new Uint8Array(analyser.frequencyBinCount);
    analyser.getByteFrequencyData(data);
    let sum = 0;
    for (const v of data) sum += v;
    level = 0.12 + (sum / data.length / 255) * 0.9;
  }
  orbLevel += (level - orbLevel) * 0.2;
  const cx = w / 2, cy = h / 2;
  const base = Math.min(w, h) * 0.28;
  const t = performance.now() / 1000;
  for (let ring = 3; ring >= 0; ring--) {
    const r = base * (1 + orbLevel * (ring + 1) * 0.35);
    orbCtx.beginPath();
    for (let a = 0; a <= Math.PI * 2 + 0.01; a += 0.05) {
      const wobble = 1 + 0.04 * orbLevel *
        Math.sin(a * (3 + ring) + t * (1.5 + ring * 0.7));
      const x = cx + Math.cos(a) * r * wobble;
      const y = cy + Math.sin(a) * r * wobble;
      if (a === 0) orbCtx.moveTo(x, y); else orbCtx.lineTo(x, y);
    }
    const hue = 200 + ring * 25 + orbLevel * 40;
    orbCtx.strokeStyle = `hsla(${hue}, 85%, 60%, ${0.9 - ring * 0.2})`;
    orbCtx.lineWidth = ring === 0 ? 2.5 : 1.2;
    orbCtx.stroke();
  }
}
drawOrb();

function attachAnalyser(audioEl) {
  if (audioEl._wired) return;
  audioEl._wired = true;
  const ctx = new (window.AudioContext || window.webkitAudioContext)();
  const src = ctx.createMediaElementSource(audioEl);
  analyser = ctx.createAnalyser();
  analyser.fftSize = 256;
  src.connect(analyser);
  analyser.connect(ctx.destination);
}

// ------------------------------------------------------------------- TTS

const ttsAudio = $("tts-audio");
const history = [];

for (const [slider, label] of [["tts-speed", "tts-speed-val"],
                               ["tts-temp", "tts-temp-val"]]) {
  $(slider).addEventListener("input", () =>
    $(label).textContent = Number($(slider).value).toFixed(2).replace(/0$/, ""));
}

async function refreshVoices() {
  try {
    const r = await fetch(`${API}/v1/audio/voices`);
    const data = await r.json();
    const sel = $("tts-voice");
    const current = sel.value;
    sel.innerHTML = '<option value="">(default)</option>';
    for (const voices of Object.values(data.voices || {})) {
      for (const v of voices) {
        const o = document.createElement("option");
        o.value = o.textContent = v;
        sel.appendChild(o);
      }
    }
    sel.value = current;
  } catch { /* server offline; leave default */ }
}
refreshVoices();

function renderHistory() {
  const ul = $("tts-history");
  ul.innerHTML = "";
  for (const item of history.slice().reverse()) {
    const li = document.createElement("li");
    const span = document.createElement("span");
    span.textContent = `${item.text.slice(0, 60)} — ${item.when}`;
    const btn = document.createElement("button");
    btn.textContent = "Play";
    btn.addEventListener("click", async () => {
      ttsAudio.src = item.url;
      attachAnalyser(ttsAudio);
      renderWaveform(await (await fetch(item.url)).blob());
      ttsAudio.play();
    });
    li.append(span, btn);
    ul.appendChild(li);
  }
}

// -------------------------------------------------------------- waveform
// Static min/max-envelope render of the generated audio (reference Studio
// shows the output waveform; ref ui/components/audio-orb.tsx is the live
// visualizer — the orb above covers that). Playhead tracks the <audio>
// element; click to seek.

const wave = $("waveform");
const waveCtx = wave.getContext("2d");
let waveEnv = null;     // [{min,max} per pixel column]
let waveDur = 0;

async function renderWaveform(blob) {
  try {
    const ctx = new (window.AudioContext || window.webkitAudioContext)();
    const buf = await ctx.decodeAudioData(await blob.arrayBuffer());
    const data = buf.getChannelData(0);
    waveDur = buf.duration;
    const w = wave.width;
    const per = Math.max(1, Math.floor(data.length / w));
    waveEnv = [];
    for (let i = 0; i < w; i++) {
      let mn = 1, mx = -1;
      const s0 = i * per, s1 = Math.min(s0 + per, data.length);
      for (let s = s0; s < s1; s++) {
        const v = data[s];
        if (v < mn) mn = v;
        if (v > mx) mx = v;
      }
      waveEnv.push(s0 < data.length ? { mn, mx } : { mn: 0, mx: 0 });
    }
    wave.hidden = false;
    ctx.close();
  } catch (e) {
    wave.hidden = true;
    waveEnv = null;
  }
}

function drawWaveform() {
  requestAnimationFrame(drawWaveform);
  if (wave.hidden || !waveEnv) return;
  const { width: w, height: h } = wave;
  const css = getComputedStyle(document.documentElement);
  waveCtx.clearRect(0, 0, w, h);
  const mid = h / 2;
  const played = waveDur && ttsAudio.duration
    ? (ttsAudio.currentTime / ttsAudio.duration) * w : 0;
  for (let i = 0; i < waveEnv.length; i++) {
    const { mn, mx } = waveEnv[i];
    waveCtx.strokeStyle = css.getPropertyValue(
      i <= played ? "--accent" : "--border").trim() || "#888";
    waveCtx.beginPath();
    waveCtx.moveTo(i + 0.5, mid - Math.max(mx * mid * 0.92, 0.6));
    waveCtx.lineTo(i + 0.5, mid - Math.min(mn * mid * 0.92, -0.6));
    waveCtx.stroke();
  }
}
drawWaveform();

wave.addEventListener("click", (ev) => {
  if (!ttsAudio.duration) return;
  const frac = (ev.offsetX / wave.clientWidth);
  ttsAudio.currentTime = frac * ttsAudio.duration;
  ttsAudio.play().catch(() => {});
});

// Progressive playback of a chunked PCM16 stream: decode each fetch chunk
// into an AudioBuffer and schedule it back-to-back on a WebAudio clock.
async function playPcmStream(resp, status) {
  const sr = Number(resp.headers.get("X-Sample-Rate") || 24000);
  const ctx = new (window.AudioContext || window.webkitAudioContext)(
    { sampleRate: sr });
  analyser = ctx.createAnalyser();
  analyser.fftSize = 256;
  analyser.connect(ctx.destination);
  const reader = resp.body.getReader();
  let playT = ctx.currentTime + 0.05;
  let leftover = new Uint8Array(0);
  const parts = [];
  let first = true;
  const t0 = performance.now();
  for (;;) {
    const { done, value } = await reader.read();
    if (done) break;
    if (first) {
      status.textContent =
        `first audio in ${((performance.now() - t0) / 1000).toFixed(2)}s…`;
      first = false;
    }
    let bytes = value;
    if (leftover.length) {
      bytes = new Uint8Array(leftover.length + value.length);
      bytes.set(leftover); bytes.set(value, leftover.length);
    }
    const n = bytes.length & ~1;
    leftover = bytes.slice(n);
    if (!n) continue;
    parts.push(bytes.slice(0, n));
    const i16 = new Int16Array(bytes.buffer.slice(0, n));
    const f32 = Float32Array.from(i16, (v) => v / 32768);
    const buf = ctx.createBuffer(1, f32.length, sr);
    buf.copyToChannel(f32, 0);
    const src = ctx.createBufferSource();
    src.buffer = buf;
    src.connect(analyser);
    playT = Math.max(playT, ctx.currentTime + 0.02);
    src.start(playT);
    playT += buf.duration;
  }
  // assemble a WAV for the download link / history
  return pcm16PartsToWav(parts, sr);
}

function pcm16PartsToWav(parts, sr) {
  const total = parts.reduce((a, p) => a + p.length, 0);
  const wav = new Uint8Array(44 + total);
  const dv = new DataView(wav.buffer);
  const wr = (off, s) => { for (let i = 0; i < s.length; i++) wav[off + i] = s.charCodeAt(i); };
  wr(0, "RIFF"); dv.setUint32(4, 36 + total, true); wr(8, "WAVEfmt ");
  dv.setUint32(16, 16, true); dv.setUint16(20, 1, true);
  dv.setUint16(22, 1, true); dv.setUint32(24, sr, true);
  dv.setUint32(28, sr * 2, true); dv.setUint16(32, 2, true);
  dv.setUint16(34, 16, true); wr(36, "data"); dv.setUint32(40, total, true);
  let off = 44;
  for (const p of parts) { wav.set(p, off); off += p.length; }
  return new Blob([wav], { type: "audio/wav" });
}

$("tts-generate").addEventListener("click", async () => {
  const status = $("tts-status");
  status.className = "status";
  status.textContent = "generating…";
  $("tts-generate").disabled = true;
  try {
    const streaming = $("tts-stream").checked;
    const body = {
      model: $("tts-model").value.trim(),
      input: $("tts-text").value,
      speed: Number($("tts-speed").value),
      temperature: Number($("tts-temp").value),
      response_format: streaming ? "pcm" : "wav",
    };
    if (streaming) { body.stream = true; body.streaming_interval = 0.5; }
    if ($("tts-voice").value) body.voice = $("tts-voice").value;
    if ($("tts-clone").value) body.ref_audio = `voice:${$("tts-clone").value}`;
    const r = await fetch(`${API}/v1/audio/speech`, {
      method: "POST",
      headers: { "Content-Type": "application/json" },
      body: JSON.stringify(body),
    });
    if (!r.ok) throw new Error((await r.json()).error || r.statusText);
    const blob = streaming ? await playPcmStream(r, status) : await r.blob();
    const url = URL.createObjectURL(blob);
    ttsAudio.src = url;
    attachAnalyser(ttsAudio);
    renderWaveform(blob);
    $("tts-play").disabled = false;
    const dl = $("tts-download");
    dl.href = url;
    dl.hidden = false;
    history.push({ text: body.input, url, when: new Date().toLocaleTimeString() });
    renderHistory();
    refreshVoices();
    status.textContent = "done";
    ttsAudio.play().catch(() => {});
  } catch (e) {
    status.className = "status err";
    status.textContent = `error: ${e.message}`;
  } finally {
    $("tts-generate").disabled = false;
  }
});

$("tts-play").addEventListener("click", () => {
  if (ttsAudio.paused) { ttsAudio.play(); $("tts-play").textContent = "Pause"; }
  else { ttsAudio.pause(); $("tts-play").textContent = "Play"; }
});
ttsAudio.addEventListener("ended", () => $("tts-play").textContent = "Play");

// ------------------------------------------------------------------- STT

$("stt-transcribe").addEventListener("click", async () => {
  const status = $("stt-status");
  const file = $("stt-file").files[0];
  status.className = "status";
  if (!file) { status.textContent = "pick a file first"; return; }
  status.textContent = "transcribing…";
  $("stt-transcribe").disabled = true;
  try {
    const form = new FormData();
    form.append("file", file);
    form.append("model", $("stt-model").value.trim());
    form.append("response_format", "verbose_json");
    const r = await fetch(`${API}/v1/audio/transcriptions`,
                          { method: "POST", body: form });
    const data = await r.json();
    if (!r.ok) throw new Error(data.error || r.statusText);
    $("stt-text").textContent = data.text || "(empty)";
    const table = $("stt-segments");
    const tbody = table.querySelector("tbody");
    tbody.innerHTML = "";
    const segs = data.segments || [];
    table.hidden = segs.length === 0;
    for (const s of segs) {
      const tr = document.createElement("tr");
      for (const cell of [s.start, s.end, s.text]) {
        const td = document.createElement("td");
        td.textContent = cell;
        tr.appendChild(td);
      }
      tbody.appendChild(tr);
    }
    status.textContent = "done";
  } catch (e) {
    status.className = "status err";
    status.textContent = `error: ${e.message}`;
  } finally {
    $("stt-transcribe").disabled = false;
  }
});

// -------------------------------------------------------------- realtime

let rtWs = null, rtCtx = null, rtNode = null, rtStream = null;

function setVadState(state) {
  const pill = $("rt-vad-state");
  pill.hidden = false;
  pill.textContent = state;
  pill.className = `vad-state ${state.replace(/\W.*/, "")}`;
}

function f32ToPcm16(f32) {
  const i16 = new Int16Array(f32.length);
  for (let i = 0; i < f32.length; i++) {
    i16[i] = Math.max(-32768, Math.min(32767, Math.round(f32[i] * 32768)));
  }
  return i16;
}

// OpenAI-style /v1/realtime session: base64 append events in, VAD +
// transcription events out (server.py realtime handler).
function openRealtimeSession(model, status) {
  const proto = location.protocol === "https:" ? "wss" : "ws";
  const ws = new WebSocket(
    `${proto}://${location.host}/v1/realtime` +
    `?model=${encodeURIComponent(model)}`);
  ws.onmessage = (ev) => {
    let m;
    try { m = JSON.parse(ev.data); } catch { return; }
    switch (m.type) {
      case "session.created":
        setVadState(m.session?.turn_detection ? "listening" : "no VAD");
        break;
      case "input_audio_buffer.speech_started":
        setVadState(`speech @${(m.audio_start_ms / 1000).toFixed(1)}s`);
        break;
      case "input_audio_buffer.speech_stopped":
        setVadState("committing");
        break;
      case "input_audio_buffer.committed":
        setVadState("committed");
        break;
      case "conversation.item.input_audio_transcription.delta":
        $("rt-text").textContent += m.delta || "";
        break;
      case "conversation.item.input_audio_transcription.completed":
        $("rt-text").textContent =
          $("rt-text").textContent.trimEnd() + ` ${m.transcript || ""}\n`;
        setVadState("listening");
        break;
      case "error":
        status.className = "status err";
        status.textContent = `error: ${m.error?.message || m.error}`;
        break;
    }
  };
  ws.sendAudio = (f32) => {
    if (ws.readyState !== 1) return;
    const bytes = new Uint8Array(f32ToPcm16(f32).buffer);
    let bin = "";
    for (let i = 0; i < bytes.length; i += 0x8000) {
      bin += String.fromCharCode.apply(null, bytes.subarray(i, i + 0x8000));
    }
    ws.send(JSON.stringify({ type: "input_audio_buffer.append",
                             audio: btoa(bin) }));
  };
  ws.isVadSession = true;
  return ws;
}

function openTranscribeFeed(model) {
  const proto = location.protocol === "https:" ? "wss" : "ws";
  const ws = new WebSocket(
    `${proto}://${location.host}/v1/audio/transcriptions/realtime` +
    `?model=${encodeURIComponent(model)}`);
  ws.onmessage = (ev) => {
    try {
      const m = JSON.parse(ev.data);
      if (m.text) $("rt-text").textContent += m.text;
      if (m.delta) $("rt-text").textContent += m.delta;
    } catch { /* non-JSON frame */ }
  };
  ws.sendAudio = (f32) => {
    if (ws.readyState === 1) ws.send(f32ToPcm16(f32).buffer);
  };
  return ws;
}

$("rt-start").addEventListener("click", async () => {
  const status = $("rt-status");
  status.className = "status";
  try {
    rtStream = await navigator.mediaDevices.getUserMedia({ audio: true });
    const model = $("rt-model").value.trim();
    rtWs = $("rt-vad").checked
      ? openRealtimeSession(model, status)
      : openTranscribeFeed(model);
    rtWs.onclose = () => { status.textContent = "closed"; };
    rtCtx = new AudioContext({ sampleRate: 16000 });
    const src = rtCtx.createMediaStreamSource(rtStream);
    rtNode = rtCtx.createScriptProcessor(4096, 1, 1);
    rtNode.onaudioprocess = (e) =>
      rtWs.sendAudio(e.inputBuffer.getChannelData(0));
    src.connect(rtNode);
    rtNode.connect(rtCtx.destination);
    $("rt-start").disabled = true;
    $("rt-stop").disabled = false;
    status.textContent = "streaming…";
  } catch (e) {
    status.className = "status err";
    status.textContent = `error: ${e.message}`;
  }
});

$("rt-stop").addEventListener("click", () => {
  rtNode?.disconnect();
  rtCtx?.close();
  rtStream?.getTracks().forEach((t) => t.stop());
  // use the mode the session was STARTED in (toggling the checkbox
  // mid-session must not change how the live socket is closed)
  if (rtWs?.readyState === 1 && rtWs.isVadSession) {
    rtWs.send(JSON.stringify({ type: "session.close" }));
  }
  rtWs?.close();
  $("rt-vad-state").hidden = true;
  $("rt-start").disabled = false;
  $("rt-stop").disabled = true;
  $("rt-status").textContent = "stopped";
});

// ------------------------------------------------------------ separation

function b64ToBlobUrl(b64, mime = "audio/wav") {
  const bin = atob(b64);
  const bytes = new Uint8Array(bin.length);
  for (let i = 0; i < bin.length; i++) bytes[i] = bin.charCodeAt(i);
  return URL.createObjectURL(new Blob([bytes], { type: mime }));
}

// ---------------------------------------------------------- voice library

let vcRecorder = null;   // {ctx, node, stream, parts, sr} while recording
let vcBlob = null;       // recorded WAV awaiting save

async function refreshCustomVoices() {
  try {
    const r = await fetch(`${API}/v1/audio/voices`);
    const data = await r.json();
    const voices = data.custom || [];
    const tbody = $("vc-table").querySelector("tbody");
    tbody.innerHTML = "";
    $("vc-empty").hidden = voices.length > 0;
    $("vc-table").hidden = voices.length === 0;
    const clone = $("tts-clone");
    const current = clone.value;
    clone.innerHTML = '<option value="">(none)</option>';
    for (const v of voices) {
      const o = document.createElement("option");
      o.value = o.textContent = v.name;
      clone.appendChild(o);
      const tr = document.createElement("tr");
      for (const cell of [v.name, v.duration_s ? `${v.duration_s}s` : "",
                          v.ref_text || ""]) {
        const td = document.createElement("td");
        td.textContent = cell;
        tr.appendChild(td);
      }
      const td = document.createElement("td");
      const play = document.createElement("button");
      play.textContent = "Play";
      play.addEventListener("click", () => {
        const a = $("vc-audio");
        a.src = `${API}/v1/audio/voices/${encodeURIComponent(v.name)}`;
        a.play();
      });
      const use = document.createElement("button");
      use.textContent = "Use in TTS";
      use.addEventListener("click", () => {
        $("tts-clone").value = v.name;
        location.hash = "#/tts";
      });
      const del = document.createElement("button");
      del.textContent = "Delete";
      del.addEventListener("click", async () => {
        del.disabled = true;
        await fetch(`${API}/v1/audio/voices/${encodeURIComponent(v.name)}`,
                    { method: "DELETE" });
        refreshCustomVoices();
      });
      td.append(play, use, del);
      tr.appendChild(td);
      tbody.appendChild(tr);
    }
    clone.value = current;
  } catch { /* server offline */ }
}
refreshCustomVoices();

// Mic capture assembles a PCM16 WAV client-side (MediaRecorder's webm/opus
// would need ffmpeg server-side; the server decodes WAV natively).
$("vc-record").addEventListener("click", async () => {
  const btn = $("vc-record");
  const pill = $("vc-rec-state");
  if (vcRecorder) {                       // stop + assemble
    const { ctx, node, stream, parts, sr } = vcRecorder;
    node.disconnect();
    ctx.close();
    stream.getTracks().forEach((t) => t.stop());
    vcRecorder = null;
    vcBlob = pcm16PartsToWav(parts, sr);
    btn.textContent = "Record mic";
    pill.hidden = true;
    $("vc-status").textContent =
      `recorded ${(parts.reduce((a, p) => a + p.length, 0) / 2 / sr)
        .toFixed(1)}s — press Save`;
    return;
  }
  try {
    const stream = await navigator.mediaDevices.getUserMedia({ audio: true });
    const ctx = new AudioContext({ sampleRate: 24000 });
    const src = ctx.createMediaStreamSource(stream);
    const node = ctx.createScriptProcessor(4096, 1, 1);
    const parts = [];
    node.onaudioprocess = (e) => {
      parts.push(new Uint8Array(
        f32ToPcm16(e.inputBuffer.getChannelData(0)).buffer));
    };
    src.connect(node);
    node.connect(ctx.destination);
    vcRecorder = { ctx, node, stream, parts, sr: ctx.sampleRate };
    btn.textContent = "Stop recording";
    pill.hidden = false;
  } catch (e) {
    $("vc-status").className = "status err";
    $("vc-status").textContent = `mic error: ${e.message}`;
  }
});

$("vc-save").addEventListener("click", async () => {
  const status = $("vc-status");
  status.className = "status";
  const name = $("vc-name").value.trim();
  if (!name) { status.textContent = "name the voice first"; return; }
  const file = $("vc-file").files[0];
  const blob = file || vcBlob;
  if (!blob) { status.textContent = "record or pick a wav first"; return; }
  status.textContent = "saving…";
  $("vc-save").disabled = true;
  try {
    const bytes = new Uint8Array(await blob.arrayBuffer());
    let bin = "";
    for (let i = 0; i < bytes.length; i += 0x8000) {
      bin += String.fromCharCode.apply(null, bytes.subarray(i, i + 0x8000));
    }
    const r = await fetch(`${API}/v1/audio/voices`, {
      method: "POST",
      headers: { "Content-Type": "application/json" },
      body: JSON.stringify({ name, audio: btoa(bin),
                             ref_text: $("vc-text").value.trim() || null }),
    });
    const data = await r.json();
    if (!r.ok) throw new Error(data.error || r.statusText);
    status.textContent = `saved “${data.name}” (${data.duration_s}s)`;
    vcBlob = null;
    $("vc-file").value = "";
    refreshCustomVoices();
  } catch (e) {
    status.className = "status err";
    status.textContent = `error: ${e.message}`;
  } finally {
    $("vc-save").disabled = false;
  }
});

// --------------------------------------------------------------- models

async function refreshModels() {
  try {
    const r = await fetch(`${API}/v1/models`);
    const data = await r.json();
    const rows = data.data || [];
    const tbody = $("mdl-table").querySelector("tbody");
    tbody.innerHTML = "";
    $("mdl-empty").hidden = rows.length > 0;
    $("mdl-table").hidden = rows.length === 0;
    for (const m of rows) {
      const tr = document.createElement("tr");
      const td = document.createElement("td");
      td.textContent = m.id;
      const td2 = document.createElement("td");
      const btn = document.createElement("button");
      btn.textContent = "Unload";
      btn.addEventListener("click", async () => {
        btn.disabled = true;
        await fetch(`${API}/v1/models/${encodeURIComponent(m.id)}`,
                    { method: "DELETE" });
        refreshModels();
      });
      td2.appendChild(btn);
      tr.append(td, td2);
      tbody.appendChild(tr);
    }
  } catch { /* server offline */ }
}
refreshModels();
setInterval(refreshModels, 15000);

$("mdl-load").addEventListener("click", async () => {
  const status = $("mdl-status");
  const name = $("mdl-name").value.trim();
  status.className = "status";
  if (!name) { status.textContent = "enter a model id"; return; }
  status.textContent = "loading… (first load downloads + compiles)";
  $("mdl-load").disabled = true;
  try {
    const r = await fetch(`${API}/v1/models`, {
      method: "POST",
      headers: { "Content-Type": "application/json" },
      body: JSON.stringify({ model: name }),
    });
    const data = await r.json();
    if (!r.ok) throw new Error(data.error || r.statusText);
    status.textContent = "loaded";
    refreshModels();
  } catch (e) {
    status.className = "status err";
    status.textContent = `error: ${e.message}`;
  } finally {
    $("mdl-load").disabled = false;
  }
});

$("sep-run").addEventListener("click", async () => {
  const status = $("sep-status");
  const file = $("sep-file").files[0];
  status.className = "status";
  if (!file) { status.textContent = "pick a file first"; return; }
  status.textContent = "separating…";
  $("sep-run").disabled = true;
  try {
    const form = new FormData();
    form.append("file", file);
    form.append("model", $("sep-model").value.trim());
    form.append("description", $("sep-desc").value);
    form.append("steps", $("sep-steps").value);
    const r = await fetch(`${API}/v1/audio/separations`,
                          { method: "POST", body: form });
    const data = await r.json();
    if (!r.ok || data.error) throw new Error(data.error || r.statusText);
    if (data.target) $("sep-target").src = b64ToBlobUrl(data.target);
    if (data.residual) $("sep-residual").src = b64ToBlobUrl(data.residual);
    status.textContent = "done";
  } catch (e) {
    status.className = "status err";
    status.textContent = `error: ${e.message}`;
  } finally {
    $("sep-run").disabled = false;
  }
});
