/* <tuun-synth>: the Tuun synthesizer web component, server edition.
 *
 * Same element API as the reference component (web/tuun-synth.js in the
 * Rust repo): attributes `description`, `open` (JSON list of modules),
 * `expression` (or a <script type="text/tuun"> body), `sliders` (JSON
 * list of "label:initial:min:max" / "label:initial:fn(x) => ..."),
 * boolean `controls` and `expanded`.
 *
 * Where the reference instantiates a WASM engine inside an
 * AudioWorkletProcessor and pumps tuun.process(output) per 128-sample
 * quantum (web/tuun-processor.js:46-69), this element streams rendered
 * float32 blocks from the local tuun-jax server (tools/web_demo.py) and
 * feeds them to a queue-draining worklet — the process() pump runs on
 * the server's end of a chunked HTTP response instead of in-page.
 */

const FEED_WORKLET = `
class TuunFeed extends AudioWorkletProcessor {
  constructor() {
    super();
    this.queue = [];
    this.offset = 0;
    this.ended = false;
    this.played = 0;
    this.port.onmessage = (e) => {
      if (e.data === null) this.ended = true;
      else this.queue.push(e.data);
    };
  }
  process(_inputs, outputs) {
    const out = outputs[0][0];
    let i = 0;
    while (i < out.length && this.queue.length) {
      const head = this.queue[0];
      const n = Math.min(out.length - i, head.length - this.offset);
      out.set(head.subarray(this.offset, this.offset + n), i);
      i += n;
      this.offset += n;
      if (this.offset === head.length) { this.queue.shift(); this.offset = 0; }
    }
    this.played += i;
    for (; i < out.length; i++) out[i] = 0;
    if (this.ended && !this.queue.length) {
      this.port.postMessage({done: true});
      return false;
    }
    return true;
  }
}
registerProcessor('tuun-feed', TuunFeed);
`;

class TuunSynth extends HTMLElement {
  constructor() {
    super();
    // Random ids: a per-page counter would collide across tabs (two
    // tabs' "el1" would share one server session and kill each other's
    // streams via the generation bump).
    this.id_ = (crypto.randomUUID ? crypto.randomUUID()
                : `el${Math.random().toString(36).slice(2)}`);
    this.ctx = null;
    this.node = null;
    this.abort = null;
    this.playing = false;
    this.kind = null;
    this.heldKeys = new Set();
  }

  connectedCallback() {
    const root = this.attachShadow({mode: 'open'});
    const description = this.getAttribute('description') || '';
    const expanded = this.hasAttribute('expanded') || !description;
    const controls = this.hasAttribute('controls');
    root.innerHTML = `
      <style>
        .box { border: 1px solid #ccc; border-radius: 6px; background: #fff;
               padding: 10px; margin: 8px 0; font-family: inherit; }
        .row { display: flex; align-items: center; gap: 8px; }
        button { min-width: 64px; }
        textarea { width: 100%; box-sizing: border-box; font-family: monospace;
                   min-height: 3em; margin-top: 8px; }
        .body { display: ${expanded ? 'block' : 'none'}; }
        .slider-row { display: flex; align-items: center; gap: 6px;
                      font-size: 13px; margin-top: 4px; }
        .slider-row input { flex: 1; }
        .val { min-width: 70px; text-align: right; font-family: monospace; }
        .status { color: #888; font-size: 12px; margin-top: 6px;
                  white-space: pre-wrap; }
        canvas.scope { width: 100%; height: 56px; display: none;
                       background: #111; border-radius: 4px;
                       margin-top: 8px; }
        .keys { margin-top: 6px; display: none; }
        .keys button { min-width: 34px; }
        .desc { flex: 1; color: #444; }
        .twist { cursor: pointer; user-select: none; color: #888; }
      </style>
      <div class="box">
        <div class="row">
          <button class="play">Play</button>
          <span class="desc">${description}</span>
          ${description ? '<span class="twist">[code]</span>' : ''}
        </div>
        <div class="body">
          <textarea spellcheck="false"></textarea>
          <div class="sliders"></div>
          <div class="keys"></div>
          <canvas class="scope" width="560" height="56"></canvas>
        </div>
        <div class="status"></div>
      </div>`;
    this.$ = (sel) => root.querySelector(sel);
    this.$('.play').addEventListener('click', () => this.toggle());
    const twist = this.$('.twist');
    if (twist) twist.addEventListener('click', () => {
      const b = this.$('.body');
      b.style.display = b.style.display === 'none' ? 'block' : 'none';
    });
    const scriptBody = this.querySelector('script[type="text/tuun"]');
    const expr = this.getAttribute('expression') ||
        (scriptBody ? scriptBody.textContent.trim() : '');
    this.$('textarea').value = expr;
    if (!controls && !this.hasAttribute('expanded') && description)
      this.$('.body').style.display = 'none';
  }

  status(msg) { this.$('.status').textContent = msg; }

  async api(path, body) {
    const r = await fetch(path, {method: 'POST',
                                 headers: {'Content-Type': 'application/json'},
                                 body: JSON.stringify(body)});
    const out = await r.json();
    if (!r.ok) throw new Error(out.error || r.statusText);
    return out;
  }

  async toggle() {
    if (this.playing) return this.stop();
    try { await this.play(); }
    catch (e) { this.status(`error: ${e.message}`); this.stop(); }
  }

  async play() {
    const body = {
      id: this.id_,
      expression: this.$('textarea').value,
      sliders: this.getAttribute('sliders') || null,
      opens: JSON.parse(this.getAttribute('open') || '["std"]'),
    };
    const info = await this.api('/api/install', body);
    this.kind = info.kind;
    this.renderSliders(info.sliders);
    this.playing = true;
    this.$('.play').textContent = 'Stop';
    if (info.kind === 'keys') {
      // The stream starts now and carries silence between notes (the
      // server keeps keys streams alive through idle gaps), so note_on
      // never races a lazy stream restart — and it runs at the
      // server's sample rate, not a hardcoded one.
      this.renderKeys();
      this.status('keys instrument installed — click the keys');
      // Deliberately not awaited (notes must not wait on the stream
      // handshake) — but a failure here would otherwise be an unhandled
      // rejection with the element stuck on 'Stop', so surface it.
      this.startStream(info.sample_rate).catch((e) => {
        this.status(`error: ${e.message}`);
        this.stop();
      });
      return;
    }
    this.$('.keys').style.display = 'none';
    await this.startStream(info.sample_rate);
  }

  async ensureAudio(sampleRate) {
    if (this.ctx && this.ctx.sampleRate === sampleRate) return;
    if (this.ctx) await this.ctx.close();
    this.ctx = new AudioContext({sampleRate});
    const url = URL.createObjectURL(
        new Blob([FEED_WORKLET], {type: 'application/javascript'}));
    await this.ctx.audioWorklet.addModule(url);
  }

  async startStream(sampleRate) {
    await this.ensureAudio(sampleRate);
    this.node = new AudioWorkletNode(this.ctx, 'tuun-feed',
                                     {outputChannelCount: [1]});
    this.node.port.onmessage = (e) => { if (e.data.done) this.stop(); };
    this.node.connect(this.ctx.destination);
    await this.ctx.resume();
    this.abort = new AbortController();
    const r = await fetch(`/api/stream?id=${this.id_}`,
                          {signal: this.abort.signal});
    const reader = r.body.getReader();
    let carry = new Uint8Array(0);
    let received = 0;
    const t0 = this.ctx.currentTime;
    this.status('playing');
    for (;;) {
      // Pace the pull: stay ~1.5 s ahead of the playhead so the server
      // (which renders far faster than realtime) doesn't pile buffers up.
      const ahead = received / 4 / sampleRate -
          (this.ctx.currentTime - t0);
      if (ahead > 1.5) {
        await new Promise((res) => setTimeout(res, 250));
        continue;
      }
      let chunk;
      try { chunk = await reader.read(); }
      catch (e) { break; }  // aborted
      if (chunk.done) break;
      let data = chunk.value;
      if (carry.length) {
        const merged = new Uint8Array(carry.length + data.length);
        merged.set(carry); merged.set(data, carry.length);
        data = merged;
      }
      const whole = data.length - (data.length % 4);
      carry = data.slice(whole);
      if (whole) {
        const f32 = new Float32Array(data.buffer.slice(data.byteOffset,
                                                       data.byteOffset + whole));
        received += whole;
        this.drawScope(f32);
        if (this.node) this.node.port.postMessage(f32, [f32.buffer]);
      }
    }
    if (this.node) this.node.port.postMessage(null);
  }

  // Oscilloscope over the latest buffer, clipping drawn red — the
  // reference renderer's live waveform view (renderer.rs:154-195).
  drawScope(f32) {
    const canvas = this.$('canvas.scope');
    canvas.style.display = 'block';
    const g = canvas.getContext('2d');
    const W = canvas.width, H = canvas.height, mid = H / 2;
    g.fillStyle = '#111';
    g.fillRect(0, 0, W, H);
    g.strokeStyle = '#333';
    g.beginPath(); g.moveTo(0, mid); g.lineTo(W, mid); g.stroke();
    const n = Math.min(f32.length, 2048);
    let clipped = false;
    g.strokeStyle = '#4be34b';
    g.beginPath();
    for (let x = 0; x < W; x++) {
      const v = f32[Math.floor(x / W * n)];
      if (v > 1 || v < -1) clipped = true;
      const y = mid - Math.max(-1, Math.min(1, v)) * (mid - 2);
      if (x === 0) g.moveTo(x, y); else g.lineTo(x, y);
    }
    g.stroke();
    if (clipped) {
      g.strokeStyle = '#f33';
      g.strokeRect(0.5, 0.5, W - 1, H - 1);
    }
  }

  renderSliders(sliders) {
    const host = this.$('.sliders');
    host.innerHTML = '';
    for (const s of sliders) {
      const row = document.createElement('div');
      row.className = 'slider-row';
      row.innerHTML = `<span>${s.label}</span>
        <input type="range" min="0" max="1" step="0.001" value="${s.normalized}">
        <span class="val">${Number(s.value).toPrecision(4)}</span>`;
      const input = row.querySelector('input');
      const val = row.querySelector('.val');
      input.addEventListener('input', async () => {
        try {
          const out = await this.api('/api/slider',
              {id: this.id_, label: s.label,
               normalized: parseFloat(input.value)});
          val.textContent = Number(out.value).toPrecision(4);
        } catch (e) { this.status(`error: ${e.message}`); }
      });
      host.appendChild(row);
    }
  }

  renderKeys() {
    const host = this.$('.keys');
    host.style.display = 'block';
    host.innerHTML = '';
    const names = ['C', 'D', 'E', 'F', 'G', 'A', 'B', 'C'];
    const notes = [60, 62, 64, 65, 67, 69, 71, 72];
    notes.forEach((note, i) => {
      const b = document.createElement('button');
      b.textContent = names[i];
      const release = async () => {
        if (!this.heldKeys.delete(note)) return;
        await this.api('/api/note_off', {id: this.id_, key: note});
      };
      b.addEventListener('pointerdown', async (e) => {
        // Capture the pointer so a drag-off-the-button release still
        // fires pointerup here (mouse pointers get no implicit capture
        // — without this a slide-off leaves the note stuck on).
        b.setPointerCapture(e.pointerId);
        this.heldKeys.add(note);
        await this.api('/api/note_on', {id: this.id_, key: note,
                                        velocity: 100});
      });
      b.addEventListener('pointerup', release);
      b.addEventListener('pointercancel', release);
      host.appendChild(b);
    });
  }

  async stop() {
    this.playing = false;
    this.$('.play').textContent = 'Play';
    this.status('');
    for (const note of [...this.heldKeys]) {
      this.heldKeys.delete(note);
      try { await this.api('/api/note_off', {id: this.id_, key: note}); }
      catch (e) {}
    }
    try { await this.api('/api/stop', {id: this.id_}); } catch (e) {}
    if (this.abort) { this.abort.abort(); this.abort = null; }
    if (this.node) { this.node.disconnect(); this.node = null; }
  }
}

customElements.define('tuun-synth', TuunSynth);
